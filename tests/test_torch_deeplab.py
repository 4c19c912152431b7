"""HexDeepLabV3 against the benchmark's plain reference
(``perfbench/reference/hexdeeplab.py``), the reference's own hex conv,
pool and resample against the port's, the residual join's gradient, and,
on the card, kernel B and the GN backward at 1536 and 2048 channels and
the bf16 tile at ASPP's dilations.

Tolerances.  Forward and one training step in float32 on the CPU: 1e-5
(logits) and 1e-4 relative per gradient leaf with 1e-6 absolute: the two
sides sum the same products in other orders, and GroupNorm divides the
differences by small standard deviations.  The reference's conv against
``hex_conv2d``: 1e-5 absolute and 1e-6 relative (the same products,
summed by einsum against ATen's conv, up to 37 taps x 3 channels of unit
normals).  Its max-pool and resample plan: bit-equal (the same
selections and the same float64 weight arithmetic).  On the card, as
``tests/test_torch_cuda_kernels.py`` holds kernel B: float32 1e-4 relative
with GroupNorm, bfloat16 3e-2 relative; the GN backward 1e-4 (float32) and
1e-2 (bfloat16) relative, its float32 sums over up to 2048 channels x
pixels in another order.
"""
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from hygrid_tpu_torch.kernels import conv_stack
from hygrid_tpu_torch.models import (HexDeepLabV3, create_train_state,
                                     hexify_batch, train_step)
from hygrid_tpu_torch.models.deeplab import residual_join
from hygrid_tpu_torch.nn import functional as F
from hygrid_tpu_torch.ops import geometry
from hygrid_tpu_torch.utils.profiling import counts
from perfbench.reference import hexdeeplab as R
from perfbench.reference import hexlib

ROOT = Path(__file__).resolve().parents[1]
CFG = json.load(open(ROOT / "perfbench" / "configs" / "hexdeeplabv3_r50.json"))
NARROW = dict(widths=[8, 8, 16, 16], aspp_width=16, groups=4)


def _model(seed):
    """The published block counts at narrowed widths, seeded weights in
    [-0.5, 0.5), and the reference's configuration of it."""
    m = HexDeepLabV3(21, widths=tuple(NARROW["widths"]),
                     aspp_width=NARROW["aspp_width"], groups=NARROW["groups"],
                     device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.rand(p.shape, generator=g) - 0.5)
    return m, g, dict(CFG, **NARROW)


@pytest.mark.parametrize("hw", [(16, 16), (24, 32)])
def test_forward_matches_the_reference(hw):
    m, g, cfg = _model(1)
    params = {k: v.detach().clone() for k, v in m.named_parameters()}
    x = hexify_batch(torch.rand(2, 3, 2 * hw[0], 2 * hw[1], generator=g))
    got = m(x)
    assert got.shape == (2, 21, *hw)
    torch.testing.assert_close(got, R.forward(params, x, cfg), rtol=1e-5,
                               atol=1e-5)


def test_a_training_step_matches_the_reference():
    """One step's loss and every gradient leaf (the port's train_step keeps
    them in ``.grad``) against autograd of the reference."""
    m, g, cfg = _model(2)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in m.named_parameters()}
    x = hexify_batch(torch.rand(3, 3, 32, 32, generator=g))
    labels = torch.randint(0, 21, (3, 16, 16), generator=g)
    _, metrics = train_step(create_train_state(m), x, labels)
    loss = hexlib.xent(R.forward(params, x, cfg), labels) / labels.numel()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.testing.assert_close(metrics["loss"], loss.detach(), rtol=1e-5,
                               atol=0)
    for (name, p), want in zip(m.named_parameters(), grads):
        torch.testing.assert_close(p.grad, want, rtol=1e-4, atol=1e-6,
                                   msg=lambda s: f"{name}: {s}")


@pytest.mark.parametrize("radius,stride,dilation,hw", [
    (1, 2, 1, (9, 11)), (2, 2, 1, (10, 13)), (4, 2, 1, (16, 16)),
    (4, 2, 1, (11, 7)), (2, 1, 2, (9, 10)), (2, 1, 6, (8, 7)),
    (2, 1, 18, (5, 6)), (1, 1, 1, (4, 5)),
    # wide enough that the off-centre rows and columns of the dilated taps
    # land inside the input (ASPP's 32 x 32 lattice at rate 18)
    (2, 1, 6, (15, 14)), (2, 1, 12, (27, 28)), (2, 1, 18, (40, 41)),
])
def test_reference_conv_is_the_ports_hex_conv2d(radius, stride, dilation, hw):
    g = torch.Generator().manual_seed(radius * 100 + stride * 10 + dilation)
    x = torch.randn((2, 3, *hw), generator=g)
    k = torch.randn((4, 3, F.hex_kernel_num(radius)), generator=g)
    want = F.hex_conv2d(x, k, radius=radius, stride=stride,
                        padding=dilation * (radius - 1), dilation=dilation,
                        impl="direct")
    got = R.hex_conv(x, k, radius, stride, dilation)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (9, 14), (8, 8), (2, 2)])
def test_reference_pool_is_the_ports_hex_pool2d(hw):
    x = torch.relu(torch.randn((2, 3, *hw),
                               generator=torch.Generator().manual_seed(5)))
    want = F.hex_pool2d(x, "max", kernel_size=3, stride=2, padding=1,
                        device="cpu")
    torch.testing.assert_close(R.hex_maxpool3(x), want, rtol=0, atol=0)


@pytest.mark.parametrize("src,dst", [((1, 1), (16, 16)), ((2, 2), (24, 32)),
                                     ((4, 5), (16, 16)), ((32, 32), (512, 512))])
def test_reference_resize_plan_is_the_ports_hexresize(src, dst):
    idx, wts = R.hexresize_plan(*src, *dst)
    plan = geometry.hexresize_plan(*src, *dst, "linear")
    assert np.array_equal(idx, plan.idx.reshape(3, -1))
    assert np.array_equal(wts, plan.weights.reshape(3, -1))
    x = torch.rand((2, 3, *src), generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(R.hexresize(x, dst),
                               geometry.hexresize(x, dst, device="cpu"),
                               rtol=0, atol=1e-6)


def test_residual_join_gradient_is_autograds():
    g = torch.Generator().manual_seed(7)
    a = torch.randn((2, 5, 6, 8), generator=g)
    b = torch.randn((2, 5, 6, 8), generator=g)
    b[0, 0, 0] = -a[0, 0, 0]          # joins at exactly 0
    up = torch.randn((2, 5, 6, 8), generator=g)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = residual_join(a1, b1)
    got = torch.autograd.grad(out, (a1, b1), up)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad(torch.relu(a2 + b2), (a2, b2), up)
    torch.testing.assert_close(out, torch.relu(a + b), rtol=0, atol=0)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("dilation", [1, 2, 6, 12, 18])
def test_the_bf16_tile_stages_the_rows_its_taps_read(dilation):
    """A radius-2 kernel reads 3 rows at any dilation, a 1-tap kernel one:
    the bf16 tile's patch (``compact_rows``) holds those, so ASPP's widest
    layer (Cin 2048, dilation 18) takes N = 128 in both passes, where its
    2 d + 1 rows would not fit two stages of the narrowest tile."""
    bf = torch.bfloat16
    for adjoint in (False, True):
        rows, cols = conv_stack._mma_patch_shape(2, dilation, adjoint)
        assert (rows, cols) == (3, conv_stack._patch_shape(2, dilation,
                                                           adjoint)[1])
        assert conv_stack._tile_n(bf, 2048, 256, 7, rows, cols) == 128
    assert conv_stack._mma_patch_shape(1, 1, False) == (1, 64)
    full = conv_stack._patch_shape(2, 18, False)
    assert conv_stack._mma_smem(2048, 7, 16, *full) > conv_stack._MMA_MAX_SMEM


STAGES = ("residual", "conv_strided", "hexresize", "forward")


def _stage_calls(m, x):
    before = counts()
    m(x)
    after = counts()
    return [after.get(n, 0) - before.get(n, 0) for n in STAGES]


def test_a_forward_on_the_cpu_counts_no_stage():
    """The stages count their calls on the card, as the kernel wrappers
    count their launches: a CPU forward counts itself alone."""
    m, g, _ = _model(3)
    x = hexify_batch(torch.rand(1, 3, 32, 32, generator=g))
    assert _stage_calls(m, x) == [0, 0, 0, 1]


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [1536, 2048])
def test_kernel_b_with_gn_at_wide_outputs(cuda, cout, dtype):
    """Kernel B's GN layer (conv pass, statistics, apply) above 1024 output
    channels, with and without ReLU, against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(cout)
    x = torch.rand((2, 5, 9, 64), generator=gen, device=cuda).to(dtype)
    k = torch.randn((cout, 64, 1), generator=gen, device=cuda) / 8
    gamma = 1 + 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for relu in (True, False):
        kw = dict(radius=1, norm=("gn", 32, gamma, beta), relu=relu)
        with torch.inference_mode():
            got = conv_stack.hex_conv_layer(x, k.to(dtype), **kw)
            want = conv_stack.hex_conv_layer_plain(x, k.to(dtype), **kw)
        assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_backward_at_2048_channels(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2048)
    c, groups = 2048, 32
    y = torch.randn((3, 6, 7, c), generator=gen, device=cuda)
    gout = torch.randn((3, 6, 7, c), generator=gen, device=cuda).to(dtype)
    gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((c,), generator=gen, device=cuda)
    mean, rstd = conv_stack.gn_stats_plain(y, groups)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for relu in (True, False):
        got = conv_stack.gn_relu_backward(y, mean, rstd, gamma, beta, gout,
                                          groups, relu)
        want = conv_stack.gn_relu_backward_plain(y, mean, rstd, gamma, beta,
                                                 gout, groups, relu)
        for a, b in zip(got, want):
            assert _rel(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [2, 6, 12, 18])
def test_bf16_tile_at_aspp_dilations(cuda, dilation):
    """The bf16 tile stages only the rows the dilated taps read: forward,
    dx and dW at ASPP's rates (Cin 2048 at 18) against the plain versions,
    each equal to a second launch; the lattice is over 2 d + 1 cells each
    way, so that every tap row and column reads inside the input."""
    gen = torch.Generator(device=cuda).manual_seed(dilation)
    bf = torch.bfloat16
    cin = 2048 if dilation == 18 else 64
    h, w = 2 * dilation + 4, max(33, 2 * dilation + 5)
    x = torch.rand((2, h, w, cin), generator=gen, device=cuda).to(bf)
    k = (torch.randn((48, cin, 7), generator=gen, device=cuda)
         / math.sqrt(7 * cin)).to(bf)
    g = torch.randn((2, h, w, 48), generator=gen, device=cuda).to(bf)
    kw = dict(radius=2, dilation=dilation)
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer(x, k, relu=True, **kw)
        again = conv_stack.hex_conv_layer(x, k, relu=True, **kw)
        want = conv_stack.hex_conv_layer_plain(x, k, relu=True, **kw)
    dx = conv_stack.hex_conv_layer_dgrad(g, k, **kw)
    dx_want = conv_stack.hex_conv_layer_dgrad_plain(g, k, **kw)
    dw = conv_stack.hex_conv_layer_wgrad(x, g, **kw)
    dw_want = conv_stack.hex_conv_layer_wgrad_plain(x, g, **kw)
    assert torch.equal(got, again)
    assert _rel(got, want) <= 3e-2 and _rel(dx, dx_want) <= 3e-2
    assert _rel(dw, dw_want) <= 1e-4


@pytest.mark.cuda
def test_bf16_one_tap_layers_at_2048_channels(cuda):
    """A 1 x 1 conv's forward, dx and dW (one tap a dW block) at Cin 2048
    and 1280, against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    bf = torch.bfloat16
    for cin, cout in ((2048, 512), (1280, 256), (512, 2048)):
        x = torch.rand((2, 5, 40, cin), generator=gen, device=cuda).to(bf)
        k = (torch.randn((cout, cin, 1), generator=gen, device=cuda)
             / math.sqrt(cin)).to(bf)
        g = torch.randn((2, 5, 40, cout), generator=gen, device=cuda).to(bf)
        with torch.inference_mode():
            got = conv_stack.hex_conv_layer(x, k, radius=1)
            want = conv_stack.hex_conv_layer_plain(x, k, radius=1)
        dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=1)
        dw = conv_stack.hex_conv_layer_wgrad(x, g, radius=1)
        assert _rel(got, want) <= 3e-2
        assert _rel(dx, conv_stack.hex_conv_layer_dgrad_plain(
            g, k, radius=1)) <= 3e-2
        assert _rel(dw, conv_stack.hex_conv_layer_wgrad_plain(
            x, g, radius=1)) <= 1e-4


@pytest.mark.cuda
def test_a_forward_on_the_card_counts_its_stages(cuda):
    """16 joins, the stem and two strided convs and projections, one
    resize a forward (``utils.profiling.count``)."""
    m, g, _ = _model(3)
    m = m.to(cuda)
    x = hexify_batch(torch.rand(1, 3, 32, 32, generator=g).to(cuda))
    assert _stage_calls(m, x) == [16, 5, 1, 1]


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


# the digest of _at_1024_channels' outputs from the kernels as they were
# before GroupNorm took 2048 channels and the bf16 tiles staged compact rows,
# on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128, CUDA 12.8)
AT_1024 = "892ce659e0d9bfbb"


def _at_1024_channels(cuda):
    """Kernel B's bf16 GN layer at 1024 output channels (dilation 1, 7
    taps), its dx and dW, and the GN backward at 1024 channels, from a
    seeded CUDA generator: what the widened limits and the compact rows
    must leave bit for bit as they were."""
    gen = torch.Generator(device=cuda).manual_seed(1024)
    bf = torch.bfloat16
    x = torch.rand((2, 6, 70, 64), generator=gen, device=cuda).to(bf)
    k = (torch.randn((1024, 64, 7), generator=gen, device=cuda) / 21).to(bf)
    gamma = 1 + 0.1 * torch.randn((1024,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((1024,), generator=gen, device=cuda)
    gout = torch.randn((2, 6, 70, 1024), generator=gen, device=cuda).to(bf)
    xl = x.clone().requires_grad_()
    kl = k.clone().requires_grad_()
    out = conv_stack.hex_conv_layer(xl, kl, radius=2,
                                    norm=("gn", 32, gamma, beta), relu=True)
    dx, dk = torch.autograd.grad(out, (xl, kl), gout)
    return _digest(out, dx, dk)


@pytest.mark.cuda
def test_1024_channel_outputs_are_unchanged(cuda):
    assert _at_1024_channels(cuda) == AT_1024
