"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc; each
test skips where ``torch.cuda.is_available()`` is False.  This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Tolerances: float32 within 1e-5 absolute without a norm and 1e-4 relative
with GroupNorm (it rescales summation-order differences); bfloat16 within
1e-2 (resample) and 3e-2 (conv layer, dx) relative, a few bf16 ulps of the
output once both sides round their float32 results.  dW is float32 on both
sides from the same inputs: 1e-4 relative (summation order over many
pixels).  Model grads in float32: 1e-3 relative per leaf (GN and the
backward's chain rescale summation-order differences).  The shift
resampler: float32 within 1e-6 absolute (fma against multiply-add),
bfloat16 within 1e-2 relative, the exact-select mosaic bit-equal.  The
single-op conv: float32 within 1e-5 absolute, bfloat16 within 3e-2
relative; bit-equal to ``hex_conv_layer`` on the 'same' conv in both
dtypes (the same tile and K order: the CUDA-core order in float32, the
tensor-core tile in bfloat16).  The fused stack runs the same tiles
(kernel B's tensor-core tile on row bands in bfloat16), so it is
bit-equal to chained layers in both dtypes, whichever way it stages its
weights.  The shift resampler's compact tables leave every output bit as
it was.  The split layer: the
layer's tolerances against its plain version, and bit-equal to
``hex_conv_layer`` on the concatenation; its backward (split dgrad and
wgrad) the unsplit kernels' tolerances, and bit-equal to the unsplit
kernels on each input's part.  The hex max-pool and its backward: bit-equal
to the plain path (``_window_reduce`` and its autograd) in both dtypes, NaN
payloads aside; a training step through it bit-equal to one through the
plain path; a gradient penalty's second-order gradient through it equal to
the plain path's.
"""
import math

import pytest
import torch

import numpy as np

from hygrid_tpu_torch.kernels import (_build, conv_single, conv_stack, pool,
                                      resample, resample_shift)
from hygrid_tpu_torch.models import (HexCNN, create_train_state,
                                     dense_onehot_xent, hexcnn_tiny,
                                     hexify_batch, train_step)
from hygrid_tpu_torch.models import video
from hygrid_tpu_torch.nn import HexConvModule
from hygrid_tpu_torch.nn import functional as F
from hygrid_tpu_torch.ops import geometry, sampling
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.viz import render

pytestmark = pytest.mark.cuda


def _since(before, *names):
    """Each named counter's calls (``utils.profiling.counts``) since the
    snapshot ``before``."""
    now = counts()
    return tuple(now.get(n, 0) - before.get(n, 0) for n in names)


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


PLANS = {
    "r2h-512-bilinear": lambda: geometry.rect_to_hex_plan(512, 512, 256, 256, "bilinear"),
    "r2h-61x47-nearest": lambda: geometry.rect_to_hex_plan(61, 47, 30, 25, "nearest"),
    "h2r-33x29-linear": lambda: geometry.hex_to_rect_plan(33, 29, 70, 61, "linear"),
    "resize-40x31-bilinear": lambda: geometry.hexresize_plan(40, 31, 23, 50, "bilinear"),
    "warp-37x21-linear": lambda: geometry.warp_plan(
        37, 21, [[0.9, 0.3, 1.0], [-0.2, 1.1, -2.0], [0, 0, 1]], "linear"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PLANS))
def test_plan_gather_matches_plain(cuda, name, dtype):
    plan = PLANS[name]()
    h, w = plan.src_shape
    x = torch.rand((2, 3, h, w), device=cuda).to(dtype)
    before = counts()
    got = resample.plan_gather(x, plan)
    want = sampling.apply_plan(x, plan)
    torch.cuda.synchronize()
    assert _since(before, "plan_gather") == (1,)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert _rel(got, want) <= 1e-2


# one plan of each table form, w1 not a multiple of 8 and h1 odd
# (kernels/resample.py::gather_tables)
TABLE_PLANS = {
    "parity-factored": lambda: geometry.rect_to_hex_plan(
        134, 150, 67, 75, "bilinear", hex_grid_shift=True),
    "rows-pixel": lambda: geometry.hex_to_rect_plan(35, 41, 69, 83,
                                                     "linear"),
    "parity-pixel": lambda: geometry.hex_to_rect_plan(45, 60, 45, 60,
                                                       "linear"),
    "dense-pixel": lambda: geometry.warp_plan(
        37, 21, [[0.9, 0.3, 1.0], [-0.2, 1.1, -2.0], [0, 0, 1]], "linear"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planes", [1, 3, 48, 96])
@pytest.mark.parametrize("form", list(TABLE_PLANS))
def test_plan_gather_table_forms_match_plain(cuda, form, planes, dtype):
    """Each table form at 1 to 96 planes against apply_plan, and two
    launches bit-equal."""
    plan = TABLE_PLANS[form]()
    tables = resample.gather_tables_cached(plan, torch.finfo(dtype).bits // 8)
    assert f"{tables.index_form}-{tables.weight_form}" == form
    gen = torch.Generator(device=cuda).manual_seed(planes)
    x = torch.rand((planes,) + plan.src_shape, generator=gen,
                   device=cuda).to(dtype)
    got = resample.plan_gather(x, plan)
    again = resample.plan_gather(x, plan)
    want = sampling.apply_plan(x, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 512, 256, 256), (32, 32, 16, 16),
                                   (134, 150, 67, 75)])
def test_plan_gather_factored_table_equals_the_pixel_table(cuda, shape,
                                                           dtype):
    """A rect->hex plan's factored weights give every output bit of its
    per-pixel float32 weights."""
    plan = geometry.rect_to_hex_plan(*shape, "bilinear")
    esz = torch.finfo(dtype).bits // 8
    assert resample.gather_tables_cached(plan, esz).weight_form == "factored"
    pixel = resample.gather_tables(plan, esz, factored=False)
    assert pixel.weight_form == "pixel"
    x = torch.rand((5, 3) + plan.src_shape, device=cuda).to(dtype)
    assert torch.equal(resample.plan_gather(x, plan),
                       resample._launch(x, plan, pixel))


@pytest.mark.parametrize("form", ["parity-factored", "rows-pixel"])
def test_plan_gather_last_launch_reports_the_grid(cuda, form):
    """last_launch() reads the grid of the latest launch: its column and
    row tiles are the plan's, and its plane groups cover the planes."""
    plan = TABLE_PLANS[form]()
    x = torch.rand((7,) + plan.src_shape, device=cuda)
    resample.plan_gather(x, plan)
    torch.cuda.synchronize()
    got = resample.last_launch()
    h1, w1 = plan.out_shape
    assert got["col_tiles"] == -(-w1 // resample.tile_width(4))
    assert got["row_tiles"] == -(-h1 // resample.TILE_ROWS)
    assert 1 <= got["groups"] <= 7 and got["blocks_per_sm"] >= 1
    assert got["smem"] > 0


def test_plan_gather_refuses_what_it_does_not_take(cuda):
    plan = geometry.rect_to_hex_plan(16, 16, 8, 8, "bilinear")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resample.plan_gather(torch.zeros((3, 16, 16), device=cuda,
                                         dtype=torch.float64), plan)
    with pytest.raises(ValueError, match="contiguous"):
        resample.plan_gather(torch.zeros((16, 16, 3), device=cuda
                                         ).permute(2, 0, 1), plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hexrot60_dense_plan_equals_plain(cuda, dtype):
    """hexrot60 (k=1, 256^2, C=3) runs plan_gather's dense form, one
    launch, torch.equal to apply_plan (an exact-select plan); 8-bit
    images through bfloat16 and back the same."""
    from hygrid_tpu_torch.ops import hexrot
    plan = hexrot.rot_plan(256, 256, 1)
    esz = torch.finfo(dtype).bits // 8
    assert resample.gather_tables_cached(plan, esz).index_form == "dense"
    x = (torch.rand((2, 3, 256, 256), device=cuda) * 255).to(dtype)
    before = counts()
    got = hexrot.hexrot60(x, 1)
    torch.cuda.synchronize()
    assert _since(before, "plan_gather") == (1,)
    assert got.dtype == dtype and torch.equal(got, sampling.apply_plan(x,
                                                                       plan))
    x8 = x.to(torch.uint8)
    assert torch.equal(hexrot.hexrot60(x8, 1), sampling.apply_plan(x8, plan))


LAYER_CASES = [  # (B, H, W, Cin, Cout, radius, dilation, norm kind, relu)
    (2, 11, 13, 5, 40, 2, 1, "gn", True),
    (2, 12, 9, 16, 32, 2, 1, None, True),
    (1, 10, 70, 3, 32, 2, 1, "affine", False),
    (2, 9, 14, 8, 24, 3, 1, "gn", False),
    (1, 13, 12, 7, 16, 2, 2, None, False),
    (3, 64, 63, 64, 128, 2, 1, "gn", True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LAYER_CASES)
def test_hex_conv_layer_matches_plain(cuda, case, dtype):
    b, h, w, cin, cout, r, d, kind, relu = case
    gen = torch.Generator(device=cuda).manual_seed(LAYER_CASES.index(case))
    kn = 3 * r * r - 3 * r + 1
    x = torch.rand((b, h, w, cin), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, cin, kn), generator=gen, device=cuda)
         / math.sqrt(cin * kn)).to(dtype)
    bias = norm = None
    if kind is None:
        bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    elif kind == "gn":
        norm = ("gn", math.gcd(8, cout),
                1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    else:
        norm = ("affine", 1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    kw = dict(radius=r, dilation=d, norm=norm, relu=relu)
    before = counts()
    got = conv_stack.hex_conv_layer(x, k, bias, **kw)
    want = conv_stack.hex_conv_layer_plain(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert _since(before, "hex_conv_layer") == (1,)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert _rel(got, want) <= 3e-2
    elif kind == "gn":
        assert _rel(got, want) <= 1e-4
    else:
        assert float((got - want).abs().max()) <= 1e-5


def test_hex_conv_layer_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    k = torch.zeros((8, 4, 7), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_stack.hex_conv_layer(x.double(), k, radius=2)
    with pytest.raises(ValueError, match="kernel must be"):
        conv_stack.hex_conv_layer(x, k[:, :3], radius=2)
    with pytest.raises(ValueError, match="contiguous"):
        conv_stack.hex_conv_layer(x.permute(0, 2, 1, 3), k, radius=2)


def test_hex_conv_stack_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2, 3, 20, 17), generator=gen, device=cuda)
    ks = [torch.randn((16, 3, 7), generator=gen, device=cuda) / 5,
          torch.randn((16, 16, 7), generator=gen, device=cuda) / 10]
    norms = [("gn", 8, torch.ones(16, device=cuda), torch.zeros(16, device=cuda))] * 2
    got = conv_stack.hex_conv_stack(x, ks, radius=2, norms=norms)
    want = conv_stack.hex_conv_stack(x, ks, radius=2, norms=norms, plain=True)
    assert got.shape == (2, 16, 20, 17)
    assert _rel(got, want) <= 1e-4


def test_hexcnn_on_cuda_goes_through_both_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = hexcnn_tiny(norm="GN", dtype=torch.bfloat16, device=cuda,
                        generator=gen)
    ref = hexcnn_tiny(norm="GN", device=cuda)
    ref.load_state_dict(model.state_dict())
    rect = torch.rand((4, 3, 64, 64), generator=gen, device=cuda)
    before = counts()
    with torch.inference_mode():
        out = model(hexify_batch(rect.to(torch.bfloat16)))
        want = ref(hexify_batch(rect, plain=True), plain=True)
    assert _since(before, "plan_gather", "hex_conv_layer") == (1, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 10)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, want) <= 5e-2


def test_library_is_built_once_into_build_dir(cuda):
    lib = _build.load_library()
    assert _build.load_library() is lib
    path = _build.library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR


BWD_CASES = [  # (B, H, W, Cin, Cout, radius, dilation)
    (2, 11, 13, 5, 40, 2, 1), (3, 12, 9, 32, 16, 2, 1),
    (1, 10, 70, 3, 32, 2, 1), (2, 9, 14, 8, 24, 3, 1),
    (1, 13, 12, 7, 16, 2, 2), (2, 17, 66, 64, 128, 2, 1),
    (1, 9, 11, 33, 65, 4, 1),
]


def _bwd_inputs(case, dtype, cuda):
    b, h, w, cin, cout, r, d = case
    gen = torch.Generator(device=cuda).manual_seed(BWD_CASES.index(case))
    kn = 3 * r * r - 3 * r + 1
    x = torch.rand((b, h, w, cin), generator=gen, device=cuda).to(dtype)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, cin, kn), generator=gen, device=cuda)
         / math.sqrt(cin * kn)).to(dtype)
    return x, g, k, dict(radius=r, dilation=d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_dgrad_matches_plain(cuda, case, dtype):
    x, g, k, kw = _bwd_inputs(case, dtype, cuda)
    before = counts()
    got = conv_stack.hex_conv_layer_dgrad(g, k, **kw)
    want = conv_stack.hex_conv_layer_dgrad_plain(g, k, **kw)
    torch.cuda.synchronize()
    assert _since(before, "hex_conv_layer_dgrad") == (1,)
    assert got.shape == x.shape and got.dtype == dtype
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_wgrad_matches_plain(cuda, case, dtype):
    x, g, k, kw = _bwd_inputs(case, dtype, cuda)
    before = counts()
    got = conv_stack.hex_conv_layer_wgrad(x, g, **kw)
    want = conv_stack.hex_conv_layer_wgrad_plain(x, g, **kw)
    torch.cuda.synchronize()
    assert _since(before, "hex_conv_layer_wgrad") == (1,)
    assert got.shape == k.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


def test_wgrad_is_deterministic(cuda):
    x, g, _, kw = _bwd_inputs(BWD_CASES[5], torch.bfloat16, cuda)
    first = conv_stack.hex_conv_layer_wgrad(x, g, **kw)
    assert torch.equal(first, conv_stack.hex_conv_layer_wgrad(x, g, **kw))


WGRAD_MMA_CASES = [  # (B, H, W, Cin, Cout): the bf16 GEMM's edges
    (2, 9, 65, 3, 24),      # the stem's 3 channels, a ragged step
    (3, 7, 1, 24, 48),      # one pixel a row, Cin off N = 32
    (2, 6, 65, 40, 24),     # two N tiles, the second of 8 channels
    (1, 11, 1, 40, 48),
    (2, 5, 65, 24, 48),
]


@pytest.mark.parametrize("case", WGRAD_MMA_CASES)
def test_bf16_wgrad_gemm_matches_plain_and_a_second_launch(cuda, case):
    """bf16 dW on the tensor cores at the channel counts and widths where
    its tiles are ragged: within 1e-4 of the plain version, bit-equal to a
    second launch (fixed chunks folded in order, no atomics)."""
    b, h, w, cin, cout = case
    gen = torch.Generator(device=cuda).manual_seed(
        300 + WGRAD_MMA_CASES.index(case))
    bf = torch.bfloat16
    x = torch.rand((b, h, w, cin), generator=gen, device=cuda).to(bf)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda).to(bf)
    got = conv_stack.hex_conv_layer_wgrad(x, g, radius=2)
    again = conv_stack.hex_conv_layer_wgrad(x, g, radius=2)
    want = conv_stack.hex_conv_layer_wgrad_plain(x, g, radius=2)
    torch.cuda.synchronize()
    assert got.shape == (cout, cin, 7) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("name", ["r2h-61x47-nearest", "h2r-33x29-linear",
                                  "resize-40x31-bilinear"])
def test_plan_gather_grad_matches_apply_plan(cuda, name):
    plan = PLANS[name]()
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((2, 3) + plan.src_shape, generator=gen, device=cuda)
    g = torch.randn((2, 3) + tuple(plan.out_shape), generator=gen,
                    device=cuda)
    grads = []
    for fn in (resample.plan_gather, sampling.apply_plan):
        xx = x.clone().requires_grad_()
        (fn(xx, plan) * g).sum().backward()
        grads.append(xx.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5


def _model_grads(model, rect, labels, plain):
    model.zero_grad(set_to_none=True)
    logits = model(hexify_batch(rect, plain=plain), plain=plain)
    dense_onehot_xent(logits, labels).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("norm", ["GN", None])
def test_hexcnn_kernel_path_grads_match_plain(cuda, norm):
    """Every parameter gets a grad through the kernels, equal to the plain
    path's: the conv kernels and GN affine included, not only the head."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    model = HexCNN(channels=(16, 32), depth=2, norm=norm, device=cuda,
                   generator=gen)
    rect = torch.rand((2, 3, 64, 64), generator=gen, device=cuda)
    labels = torch.tensor([3, 7], device=cuda)
    before = counts()
    got = _model_grads(model, rect, labels, plain=False)
    launched = _since(before, "plan_gather", "hex_conv_layer",
                      "hex_conv_layer_dgrad", "hex_conv_layer_wgrad",
                      "gn_relu_backward")
    want = _model_grads(model, rect, labels, plain=True)
    assert launched == (1, 4, 3, 4, 4 if norm else 0)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] is not None, name
        assert _rel(got[name], want[name]) <= 1e-3, name


class _Plain(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x, plain=True)


def test_train_step_kernel_path_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    model = HexCNN(channels=(8, 16), depth=2, norm="GN", device=cuda,
                   generator=gen)
    ref = HexCNN(channels=(8, 16), depth=2, norm="GN", device=cuda)
    ref.load_state_dict(model.state_dict())
    images = hexify_batch(torch.rand((4, 3, 32, 32), generator=gen,
                                     device=cuda))
    labels = torch.arange(4, device=cuda) % 10
    state, m = train_step(create_train_state(model), images, labels)
    ref_state, ref_m = train_step(create_train_state(_Plain(ref)), images,
                                  labels)
    assert abs(float(m["loss"]) - float(ref_m["loss"])) \
        <= 1e-4 * abs(float(ref_m["loss"]))
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        g = q.grad.abs()
        sel = g >= 1e-3 * g.max()
        assert float((p.detach() - q.detach())[sel].abs().max()) <= 1e-5, name


SHIFT_PLANS = {  # the shapes chip_smoke.py checks (phase 8): plan, lead
    "720p-b1": (lambda: geometry.rect_to_hex_plan(720, 1280, 360, 640,
                                                  "bilinear"), (1, 3)),
    "720p-b8": (lambda: geometry.rect_to_hex_plan(720, 1280, 360, 640,
                                                  "bilinear"), (8, 3)),
    "mosaic-4k": (lambda: render._mosaic_sample_plan(540, 960, 2160, 3840, 0,
                                                     None), (3,)),
    "1080p": (lambda: geometry.rect_to_hex_plan(1080, 1920, 540, 960,
                                                "bilinear"), (1, 3)),
    "512-same-size": (lambda: geometry.hex_to_rect_plan(512, 512, 512, 512,
                                                        "linear"), (1, 3)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SHIFT_PLANS))
def test_shift_resample_matches_plain(cuda, name, dtype):
    build, lead = SHIFT_PLANS[name]
    plan = build()
    # the same-size plan has unit stride and routes to plan_gather; the
    # kernel is held against its plain version there all the same
    assert sampling.takes_shift_route(plan, 2) is (name != "512-same-size")
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    x = torch.rand(lead + plan.src_shape, generator=gen,
                   device=cuda).to(dtype)
    before = counts()
    got = resample_shift.shift_resample(x, plan)
    want = resample_shift.shift_resample_plain(x, plan)
    torch.cuda.synchronize()
    assert _since(before, "shift_resample") == (1,)
    assert got.dtype == dtype and got.shape == want.shape
    if plan.exact_select:
        assert torch.equal(got, want)
    elif dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert _rel(got, want) <= 1e-2


def test_shift_resample_refuses_what_it_does_not_take(cuda):
    plan = SHIFT_PLANS["512-same-size"][0]()
    with pytest.raises(TypeError):
        resample_shift.shift_resample(
            torch.zeros((3, 512, 512), device=cuda, dtype=torch.float16),
            plan)
    with pytest.raises(ValueError, match="contiguous"):
        resample_shift.shift_resample(
            torch.zeros((512, 512, 3), device=cuda).permute(2, 0, 1), plan)


def test_shift_resample_grad_matches_apply_plan(cuda):
    plan = geometry.rect_to_hex_plan(48, 1300, 24, 650, "bilinear")
    assert sampling.takes_shift_route(plan, 4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand((2, 3) + plan.src_shape, generator=gen, device=cuda)
    g = torch.randn((2, 3) + tuple(plan.out_shape), generator=gen,
                    device=cuda)
    grads = []
    for fn in (resample_shift.shift_resample, sampling.apply_plan):
        xx = x.clone().requires_grad_()
        (fn(xx, plan) * g).sum().backward()
        grads.append(xx.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5


def test_video_frame_launches_the_shift_kernel_once(cuda):
    proc = video.make_frame_processor(720, 1280)
    frame = torch.rand((3, 720, 1280), device=cuda)
    proc(frame)
    before = counts()
    out = proc(frame)
    torch.cuda.synchronize()
    assert _since(before, "shift_resample", "plan_gather") == (1, 0)
    assert out.shape == (3, 360, 640) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"


def test_video_stream_matches_per_frame(cuda):
    rng = np.random.default_rng(0)
    frames = [rng.random((3, 72, 1280)).astype(np.float32)
              for _ in range(12)]
    proc = video.make_frame_processor(72, 1280)
    batch = video.make_batch_processor(72, 1280)
    outs = list(video.process_stream(iter(frames), proc, depth=2))
    outs_mb = list(video.process_stream(iter(frames), batch, depth=2,
                                        microbatch=4))
    assert len(outs) == len(outs_mb) == 12
    for frame, out, out_mb in zip(frames, outs, outs_mb):
        want = proc(torch.from_numpy(frame).to(cuda))
        assert torch.equal(out, want)
        assert _rel(out_mb, want) <= 1e-2


def test_mosaic_render_launches_once_and_is_bit_exact(cuda):
    """One launch a render, reading the mosaic's select table (a uint8
    slot index a phase and column, under 4 MB), bit-equal to the plain
    gather in uint8 and (through bf16) float32."""
    img = (torch.rand((3, 540, 960), device=cuda) * 255).to(torch.uint8)
    plan = render._mosaic_sample_plan(540, 960, 2160, 3840, 0, None)
    geo = resample_shift.shift_decompose_cached(plan)
    assert geo.form == "select"
    assert geo.tensors(cuda)["table_bytes"] < 4 * 2 ** 20
    render.render_mosaic(img, (2160, 3840))
    before = counts()
    out = render.render_mosaic(img, (2160, 3840))
    torch.cuda.synchronize()
    assert _since(before, "shift_resample", "plan_gather") == (1, 0)
    assert out.dtype == torch.uint8
    assert torch.equal(out, sampling.apply_plan(img, plan))
    f32 = img.float()
    out = render.render_mosaic(f32, (2160, 3840))
    assert torch.equal(out, sampling.apply_plan(
        f32.to(torch.bfloat16), plan).float())


FUSED_CASES = [  # (B, H, W, C, radius, layers, bias): the reference's fused
    (2, 16, 16, 16, 2, 3, True),   # cases, and the P-512 stack of bench.py
    (2, 18, 13, 16, 2, 4, False),
    (2, 12, 10, 32, 3, 2, True),
    (16, 256, 256, 16, 2, 11, False),
    # radius 3 with two chunks; C=128, whose one bf16 layer does not fit in
    # shared memory, so it stages one chunk of weights at a time; and C
    # off the 8-channel unit (element-wise staging, odd channel pairs)
    (1, 9, 70, 32, 3, 6, True),
    (1, 7, 40, 128, 2, 2, False),
    (2, 10, 20, 13, 2, 3, True),
]


def _fused_inputs(case, dtype, cuda):
    b, h, w, c, r, n, bias_on = case
    gen = torch.Generator(device=cuda).manual_seed(FUSED_CASES.index(case))
    kn = 3 * r * r - 3 * r + 1
    x = torch.rand((b, h, w, c), generator=gen, device=cuda).to(dtype)
    ks = [(torch.randn((c, c, kn), generator=gen, device=cuda)
           / math.sqrt(c * kn)).to(dtype) for _ in range(n)]
    bs = ([0.1 * torch.randn((c,), generator=gen, device=cuda)
           for _ in range(n)] if bias_on else [None] * n)
    relus = [True] * (n - 1) + [n % 2 == 0]
    return x, ks, bs, relus, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_stack_matches_plain_and_chained_layers(cuda, case, dtype):
    """One launch for the whole stack, within its bound of the plain
    version and bit-equal to chained hex_conv_layer launches in both
    dtypes (the same conv tile and accumulation order, the same rounding
    between layers).  In bfloat16 the tile the C side reports holds its
    invariants: N covers C, the band is warpgroups x RW rows (RW = 4, 2, 1
    for N = 16, 32, 64 and up), shared memory within a block's 227 KB, one
    layer's weights staged a block unless they do not fit."""
    x, ks, bs, relus, r = _fused_inputs(case, dtype, cuda)
    before = counts()
    got = conv_stack.hex_conv_fused_stack(x, ks, bs, radius=r, relus=relus)
    torch.cuda.synchronize()
    assert _since(before, "hex_conv_fused_stack", "hex_conv_layer") == (1, 0)
    want = conv_stack.hex_conv_fused_stack_plain(x, ks, bs, radius=r,
                                                 relus=relus)
    chained = x
    for k, b, relu in zip(ks, bs, relus):
        chained = conv_stack.hex_conv_layer(chained, k, b, radius=r,
                                            relu=relu)
    assert got.shape == x.shape and got.dtype == dtype
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 3e-2)
    assert _rel(chained, want) <= (1e-4 if dtype == torch.float32 else 3e-2)
    assert torch.equal(got, chained)
    if dtype == torch.bfloat16:
        c, plan = x.shape[-1], conv_stack.LAST_FUSED_PLAN
        assert plan["n"] == next(n for n in (16, 32, 64, 128)
                                 if c <= n or n == 128)
        assert plan["threads"] in (128, 256)
        assert plan["rows"] == plan["threads"] // 128 * \
            {16: 4, 32: 2}.get(plan["n"], 1)
        assert plan["smem"] <= conv_stack._MMA_MAX_SMEM
        assert plan["weights"] == ("chunk" if c == 128 else "layer")


def test_fused_stack_grads_match_chained_layers(cuda):
    x, ks, bs, relus, r = _fused_inputs(FUSED_CASES[0], torch.float32, cuda)
    g = torch.randn_like(x)
    runs = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, *ks, *bs)]
        n = len(ks)
        out = conv_stack.hex_conv_stack(
            leaves[0], leaves[1:n + 1], leaves[n + 1:], radius=r,
            final_activation=relus[-1], data_format="NHWC", fused=fused)
        (out * g).sum().backward()
        runs.append([t.grad for t in leaves])
    for a, b in zip(*runs):
        assert _rel(a, b) <= 1e-5


def test_hex_conv_stack_fused_option_launches_once(cuda):
    x, ks, _, _, r = _fused_inputs(FUSED_CASES[1], torch.bfloat16, cuda)
    before = counts()
    fused = conv_stack.hex_conv_stack(x, ks, radius=r, data_format="NHWC",
                                      final_activation=False, fused=True)
    assert _since(before, "hex_conv_fused_stack", "hex_conv_layer") == (1, 0)
    chained = conv_stack.hex_conv_stack(x, ks, radius=r, data_format="NHWC",
                                        final_activation=False)
    banded = conv_stack.hex_conv_stack(x, ks, radius=r, data_format="NHWC",
                                       final_activation=False, band_rows=4)
    assert torch.equal(fused, chained) and torch.equal(banded, chained)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_gather_at_the_4k_banded_plan(cuda, dtype):
    """The 4K rect->hex plan, whose 16.6 MB bf16 source the TPU runs in row
    bands (resample_pallas.py:374): plan_gather, not shift_resample."""
    plan = geometry.rect_to_hex_plan(2160, 3840, 1080, 1920, "bilinear")
    assert not sampling.takes_shift_route(plan, 2)
    x = torch.rand((1, 3, 2160, 3840), device=cuda).to(dtype)
    before = counts()
    got = sampling.apply_plan_auto(x, plan)
    torch.cuda.synchronize()
    assert _since(before, "plan_gather", "shift_resample") == (1, 0)
    want = sampling.apply_plan(x, plan)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
    else:
        assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hex_conv_layer_at_the_4k_stack_layer(cuda, dtype):
    """The P-4K stack layer (1x1080x1920, 16->16, no norm, no bias, ReLU),
    where the TPU runs its banded layer kernel (conv_pallas.py:374)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.rand((1, 1080, 1920, 16), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((16, 16, 7), generator=gen, device=cuda) / 11).to(dtype)
    got = conv_stack.hex_conv_layer(x, k, radius=2, relu=True)
    want = conv_stack.hex_conv_layer_plain(x, k, radius=2, relu=True)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert _rel(got, want) <= 3e-2


# ---- kernel B's bf16 tensor-core tile ---------------------------------------

MMA_CASES = [  # (name, B, H, W, Ca, Cb, Cout, radius, dilation): Cb > 0 is
    ("stem 3->32, W=127", 2, 6, 127, 3, 0, 32, 2, 1),       # the split layer
    ("W=63", 2, 5, 63, 32, 0, 64, 2, 1),
    ("Cout=16", 2, 7, 70, 16, 0, 16, 2, 1),
    ("Cout=128", 1, 5, 63, 64, 0, 128, 2, 1),
    ("split 24+8", 2, 6, 33, 24, 8, 32, 2, 1),
    ("split 40+24", 1, 5, 70, 40, 24, 64, 2, 1),
    ("dilation 2", 1, 9, 70, 16, 0, 32, 2, 2),
    ("radius 3", 1, 9, 40, 40, 0, 24, 3, 1),
    ("ragged M, W=65", 2, 5, 65, 32, 0, 32, 2, 1),
    ("ragged M, W=1", 3, 7, 1, 16, 0, 32, 2, 1),
    ("ragged N, Cout=24", 2, 6, 30, 16, 0, 24, 2, 1),
    ("ragged N, Cout=48", 2, 6, 30, 32, 0, 48, 2, 1),
    ("Cin=5, Cout=40", 1, 6, 19, 5, 0, 40, 2, 1),
    ("split 5+11", 1, 6, 19, 5, 11, 40, 2, 1),
]


@pytest.mark.parametrize("case", MMA_CASES, ids=[c[0] for c in MMA_CASES])
def test_bf16_tile_matches_plain_and_is_deterministic(cuda, case):
    """bf16 kernel B (the layer, or the split layer on two inputs) and its
    dx against their plain versions within 3e-2, each equal to a second
    launch, the split bit-equal to the layer on the concatenation."""
    name, b, h, w, ca, cb, cout, r, d = case
    gen = torch.Generator(device=cuda).manual_seed(100 + MMA_CASES.index(case))
    kn = F.hex_kernel_num(r)
    bf = torch.bfloat16
    xa = torch.rand((b, h, w, ca), generator=gen, device=cuda).to(bf)
    xb = torch.rand((b, h, w, cb), generator=gen, device=cuda).to(bf)
    k = (torch.randn((cout, ca + cb, kn), generator=gen, device=cuda)
         / math.sqrt((ca + cb) * kn)).to(bf)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    kw = dict(radius=r, dilation=d, relu=True)
    x = torch.cat([xa, xb], -1)
    with torch.inference_mode():
        if cb:
            got = conv_stack.hex_conv_layer_split(xa, xb, k, bias, **kw)
            again = conv_stack.hex_conv_layer_split(xa, xb, k, bias, **kw)
            assert torch.equal(got, conv_stack.hex_conv_layer(x, k, bias,
                                                              **kw))
        else:
            got = conv_stack.hex_conv_layer(x, k, bias, **kw)
            again = conv_stack.hex_conv_layer(x, k, bias, **kw)
        want = conv_stack.hex_conv_layer_plain(x, k, bias, **kw)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda).to(bf)
    dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=r, dilation=d)
    dx_again = conv_stack.hex_conv_layer_dgrad(g, k, radius=r, dilation=d)
    dx_want = conv_stack.hex_conv_layer_dgrad_plain(g, k, radius=r,
                                                    dilation=d)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, cout) and got.dtype == bf
    assert torch.equal(got, again) and torch.equal(dx, dx_again)
    assert _rel(got, want) <= 3e-2
    assert dx.shape == x.shape and _rel(dx, dx_want) <= 3e-2


def test_bf16_tile_split_dgrad_is_the_unsplit_dgrad_cut_at_ca(cuda):
    """The split dgrad's two launches cover Ca and Cb output channels with
    other tile widths (N) than the unsplit dgrad's; an output channel's sum
    does not depend on N, so the parts are bit-equal to the cut."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    bf = torch.bfloat16
    for ca, cb, cout in [(64, 64, 64), (24, 8, 32), (40, 24, 64), (5, 11, 40)]:
        g = torch.randn((2, 9, 70, cout), generator=gen, device=cuda).to(bf)
        k = (torch.randn((cout, ca + cb, 7), generator=gen, device=cuda)
             / math.sqrt((ca + cb) * 7)).to(bf)
        da, db = conv_stack.hex_conv_layer_split_dgrad(g, k, ca, radius=2)
        dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=2)
        torch.cuda.synchronize()
        assert torch.equal(da, dx[..., :ca]) and torch.equal(db, dx[..., ca:])


def test_bf16_tile_halves_n_where_shared_memory_is_short(cuda):
    """Radius 5 (61 taps) at Cout=128: two stages of a 128-channel tile do
    not fit, so the launch takes N=32 (the wrapper's mirror says so) and
    still matches the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    bf = torch.bfloat16
    kn = F.hex_kernel_num(5)
    assert conv_stack._tile_n(bf, 64, 128, kn,
                              *conv_stack._patch_shape(5, 1, False)) == 32
    x = torch.rand((1, 12, 40, 64), generator=gen, device=cuda).to(bf)
    k = (torch.randn((128, 64, kn), generator=gen, device=cuda)
         / math.sqrt(64 * kn)).to(bf)
    got = conv_stack.hex_conv_layer(x, k, radius=5)
    want = conv_stack.hex_conv_layer_plain(x, k, radius=5)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 3e-2


SINGLE_CASES = [  # (B, Cin, Cout, H, W, radius, dilation, offset, padding)
    (2, 32, 32, 20, 19, 2, 1, 0, 1),     # a BN-512 layer, cut down
    (3, 64, 128, 9, 7, 2, 1, 1, 1),      # odd parity, the BN-CIFAR width
    (2, 16, 16, 17, 70, 2, 2, 1, 2),     # dilation 2, the 16-channel tile
    (1, 5, 40, 13, 12, 3, 1, 0, 0),      # radius 3, Cin off the chunk
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SINGLE_CASES)
def test_hex_conv_single_matches_plain(cuda, case, dtype):
    b, cin, cout, h, w, r, d, off, pad = case
    gen = torch.Generator(device=cuda).manual_seed(SINGLE_CASES.index(case))
    kn = F.hex_kernel_num(r)
    x = torch.rand((b, cin, h, w), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, cin, kn), generator=gen, device=cuda)
         / math.sqrt(cin * kn)).to(dtype)
    bias = torch.randn((cout,), generator=gen, device=cuda).to(dtype)
    kw = dict(even_odd_offset=off, radius=r, padding=pad, dilation=d)
    before = counts()
    got = conv_single.hex_conv_single(x, k, bias, **kw)
    want = conv_single.hex_conv_single_plain(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert _since(before, "hex_conv_single") == (1,)
    assert got.dtype == dtype and tuple(got.shape) == (b, cout) + \
        F.hex_conv2d_output_shape(h, w, r, 1, pad, d)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert _rel(got, want) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hex_conv_single_equals_hex_conv_layer_on_the_padded_input(cuda,
                                                                   dtype):
    """The 'same' conv: the valid conv of the input padded by r-1.  It sums
    in the layer kernel's order on the same tile (float32: the CUDA-core
    order; bfloat16: the tensor-core tile with the same packed weights and
    K order), so the two agree bit for bit, and each holds its tolerance
    against the plain version.  band_rows computes the same function, bit
    for bit."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand((2, 32, 33, 70), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((48, 32, 7), generator=gen, device=cuda) / 15).to(dtype)
    got = conv_single.hex_conv_single(x, k, radius=2, padding=1)
    layer = conv_stack.hex_conv_layer(x.permute(0, 2, 3, 1).contiguous(), k,
                                      radius=2).permute(0, 3, 1, 2)
    if dtype == torch.bfloat16:
        want = conv_single.hex_conv_single_plain(x, k, radius=2, padding=1)
        assert _rel(got, want) <= 3e-2 and _rel(layer, want) <= 3e-2
    assert torch.equal(got, layer)
    assert torch.equal(got, conv_single.hex_conv_single(
        x, k, radius=2, padding=1, band_rows=4))


SHORT_ROWS = [  # (B, Cin, Cout, H, W, radius, dilation, offset): BN-CIFAR's
    (5, 32, 32, 16, 16, 2, 1, 0),    # rows of 16, 7 and 3 output pixels,
    (7, 32, 64, 8, 7, 2, 1, 0),      # packed several to a block, batches
    (3, 64, 128, 4, 3, 2, 1, 0),     # that do not divide the pack
    (3, 16, 40, 9, 7, 2, 2, 1),      # dilation 2, Cout off the tile
    (2, 24, 16, 11, 3, 3, 1, 0),     # radius 3, Cin off the chunk
]


@pytest.mark.parametrize("case", SHORT_ROWS)
def test_hex_conv_single_packs_short_rows_bit_equal_to_kernel_b(cuda, case):
    """float32 on rows shorter than a block: several output rows of one
    parity share a block, each pixel reading its own row's patch.  The sum
    keeps kernel B's order, so the result is bit-equal to
    ``hex_conv_layer``'s 'same' conv on the unpadded input, and within
    1e-5 of the plain version."""
    b, cin, cout, h, w, r, d, off = case
    gen = torch.Generator(device=cuda).manual_seed(
        200 + SHORT_ROWS.index(case))
    kn = F.hex_kernel_num(r)
    x = torch.rand((b, cin, h, w), generator=gen, device=cuda)
    k = torch.randn((cout, cin, kn), generator=gen, device=cuda) \
        / math.sqrt(cin * kn)
    kw = dict(even_odd_offset=off, radius=r, padding=d * (r - 1), dilation=d)
    before = counts()
    got = conv_single.hex_conv_single(x, k, **kw)
    assert _since(before, "hex_conv_single") == (1,)
    want = conv_single.hex_conv_single_plain(x, k, **kw)
    torch.cuda.synchronize()
    assert got.shape == (b, cout, h, w)
    assert float((got - want).abs().max()) <= 1e-5
    if off == 0:       # kernel B's 'same' conv has even rows even
        layer = conv_stack.hex_conv_layer(
            x.permute(0, 2, 3, 1).contiguous(), k, radius=r,
            dilation=d).permute(0, 3, 1, 2)
        assert torch.equal(got, layer)


def test_hex_conv_single_refuses_what_it_does_not_take(cuda):
    """An unsupported dtype raises; the plain version never runs instead."""
    x = torch.rand((1, 16, 10, 10), device=cuda)
    k = torch.rand((16, 16, 7), device=cuda)
    before = counts()
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            conv_single.hex_conv_single(x, k.to(dt), radius=2)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            F.hex_conv2d(x, k.to(dt), radius=2, padding=1, impl="pallas")
    with pytest.raises(ValueError, match="kernel must be"):
        conv_single.hex_conv_single(x, k[:, :8], radius=2)
    assert _since(before, "hex_conv_single") == (0,)


def test_hex_conv_single_grads_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand((2, 16, 12, 11), generator=gen, device=cuda)
    k = torch.randn((24, 16, 7), generator=gen, device=cuda) / 10
    bias = torch.randn((24,), generator=gen, device=cuda)
    kw = dict(even_odd_offset=1, radius=2, padding=1)
    grads = []
    for fn in (conv_single.hex_conv_single, conv_single.hex_conv_single_plain):
        leaves = [t.clone().requires_grad_() for t in (x, k, bias)]
        out = fn(*leaves, **kw)
        (out * torch.cos(out)).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-5


def test_hexconvmodule_pallas_launches_the_single_conv(cuda):
    """HexConvModule(conv_cfg impl="pallas") with BN runs one kernel launch
    and matches the same module on impl="direct" (cuDNN, TF32 off)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    mods = [HexConvModule(32, 64, 0, 2, padding=1, norm_cfg=dict(type="BN"),
                          conv_cfg=dict(type="HexConv2d", impl=impl),
                          generator=gen).eval()
            for impl in ("pallas", "direct")]
    mods[1].load_state_dict(mods[0].state_dict())
    x = torch.rand((4, 32, 24, 23), generator=gen, device=cuda)
    before = counts()
    with torch.inference_mode():
        got, want = mods[0](x), mods[1](x)
    assert _since(before, "hex_conv_single") == (1,)
    assert float((got - want).abs().max()) <= 1e-5


# ---- the split layer (TPU kernel #10 with split=True) -----------------------

SPLIT_CASES = [  # (B, H, W, Ca, Cb, Cout, norm kind, relu)
    (2, 16, 15, 32, 32, 32, "gn", True),     # dec1's split, small
    (2, 12, 11, 64, 64, 64, "gn", True),     # dec0's split, small
    (2, 10, 13, 24, 8, 16, None, True),      # a chunk straddles Ca
    (1, 9, 70, 5, 11, 40, "affine", False),  # odd counts, two channel tiles
]


def _split_case(case, cuda, dtype):
    b, h, w, ca, cb, cout, kind, relu = case
    gen = torch.Generator(device=cuda).manual_seed(SPLIT_CASES.index(case))
    xa = torch.rand((b, h, w, ca), generator=gen, device=cuda).to(dtype)
    xb = torch.rand((b, h, w, cb), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, ca + cb, 7), generator=gen, device=cuda)
         / math.sqrt((ca + cb) * 7)).to(dtype)
    bias = norm = None
    if kind is None:
        bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    elif kind == "gn":
        norm = ("gn", 8, 1 + 0.1 * torch.rand((cout,), generator=gen,
                                              device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    else:
        norm = ("affine",
                1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    return xa, xb, k, bias, dict(radius=2, norm=norm, relu=relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_layer_matches_plain_and_concat(cuda, case, dtype):
    """One split launch against its plain version (the layer's tolerances)
    and bit-equal to kernel B on the materialised concatenation, whether
    or not Ca is a multiple of the 16-channel staging chunk."""
    xa, xb, k, bias, kw = _split_case(case, cuda, dtype)
    before = counts()
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer_split(xa, xb, k, bias, **kw)
        assert _since(before, "hex_conv_layer_split",
                      "hex_conv_layer") == (1, 0)
        want = conv_stack.hex_conv_layer_split_plain(xa, xb, k, bias, **kw)
        cat = conv_stack.hex_conv_layer(torch.cat([xa, xb], -1), k, bias,
                                        **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, cat)
    if dtype == torch.bfloat16:
        assert _rel(got, want) <= 3e-2
    elif kw["norm"] is not None and kw["norm"][0] == "gn":
        assert _rel(got, want) <= 1e-4
    else:
        assert float((got - want).abs().max()) <= 1e-5


def test_split_layer_refuses_what_it_does_not_take(cuda):
    a = torch.zeros((1, 8, 8, 4), device=cuda)
    k = torch.zeros((8, 8, 7), device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="must share"):
            conv_stack.hex_conv_layer_split(a, a.bfloat16(), k, radius=2)
        with pytest.raises(ValueError, match="must share"):
            conv_stack.hex_conv_layer_split(a, a[:, :4].contiguous(), k,
                                            radius=2)
        with pytest.raises(ValueError, match="kernel must be"):
            conv_stack.hex_conv_layer_split(a, a, k[:, :6], radius=2)
        with pytest.raises(ValueError, match="contiguous"):
            conv_stack.hex_conv_layer_split(a, a.permute(0, 2, 1, 3), k,
                                            radius=2)
    # under grad it trains: grads of both inputs and the kernel through the
    # split backward kernels, equal to autograd of the plain version
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, b = (torch.rand((1, 8, 8, 4), generator=gen, device=cuda)
            for _ in range(2))
    k = torch.randn((8, 8, 7), generator=gen, device=cuda) / 8
    grads = []
    for fn in (conv_stack.hex_conv_layer_split,
               conv_stack.hex_conv_layer_split_plain):
        leaves = [t.clone().requires_grad_() for t in (a, b, k)]
        out = fn(*leaves, radius=2, relu=True)
        (out * out.detach()).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got is not None and float((got - want).abs().max()) <= 1e-5
    # an affine split layer trains too (12s in affine mode)
    norm = ("affine", 1 + 0.1 * torch.rand(8, generator=gen, device=cuda),
            0.1 * torch.randn(8, generator=gen, device=cuda))
    grads = []
    for fn in (conv_stack.hex_conv_layer_split,
               conv_stack.hex_conv_layer_split_plain):
        leaves = [t.clone().requires_grad_() for t in (a, b, k, *norm[1:])]
        out = fn(*leaves[:3], radius=2, relu=True,
                 norm=("affine", *leaves[3:]))
        (out * out.detach()).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got is not None and _rel(got, want) <= 1e-4


def test_hexunet_on_cuda_goes_through_the_kernels(cuda):
    """A small HexUNet (GN, bf16): one plan_gather, one kernel-B layer per
    encoder stage and one split layer per decoder stage, logits within
    5e-2 of the plain float32 path; the pixel-shuffle decoder too."""
    from hygrid_tpu_torch.models import HexUNet
    gen = torch.Generator(device=cuda).manual_seed(0)
    rect = torch.rand((2, 3, 64, 64), generator=gen, device=cuda)
    for upsample in ("transpose", "pixelshuffle"):
        model = HexUNet(num_classes=4, widths=(16, 32, 64), norm="GN",
                        upsample=upsample, dtype=torch.bfloat16,
                        generator=gen)
        ref = HexUNet(num_classes=4, widths=(16, 32, 64), norm="GN",
                      upsample=upsample)
        ref.load_state_dict(model.state_dict())
        before = counts()
        with torch.inference_mode():
            out = model(hexify_batch(rect.to(torch.bfloat16)))
            launched = _since(before, "plan_gather", "hex_conv_layer",
                              "hex_conv_layer_split")
            want = ref(hexify_batch(rect, plain=True), plain=True)
        assert launched == (1, 3, 2)
        assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 32, 32)
        assert bool(torch.isfinite(out).all())
        assert _rel(out, want) <= 5e-2


# ---- the split layer's backward (12s: split dgrad and split wgrad) ----------

SPLIT_BWD_CASES = [  # (B, H, W, Ca, Cb, Cout)
    (2, 12, 11, 64, 64, 64),     # dec0's split, small
    (2, 16, 15, 32, 32, 32),     # dec1's split, small
    (2, 10, 13, 24, 8, 32),      # Cb below a 16-channel staging chunk
    (1, 9, 70, 40, 24, 16),      # Ca not a multiple of a 32-channel tile
    (1, 7, 9, 5, 11, 40),        # odd counts
]


def _split_bwd_inputs(case, dtype, cuda):
    b, h, w, ca, cb, cout = case
    gen = torch.Generator(device=cuda).manual_seed(
        SPLIT_BWD_CASES.index(case))
    xa = torch.rand((b, h, w, ca), generator=gen, device=cuda).to(dtype)
    xb = torch.rand((b, h, w, cb), generator=gen, device=cuda).to(dtype)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, ca + cb, 7), generator=gen, device=cuda)
         / math.sqrt((ca + cb) * 7)).to(dtype)
    return xa, xb, g, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_BWD_CASES)
def test_split_dgrad_matches_plain_and_unsplit(cuda, case, dtype):
    """Two dgrad launches, on Ka and on Kb: dA and dB bit-equal to the
    unsplit dgrad cut at Ca, and within the dgrad tolerances of the plain
    version."""
    xa, xb, g, k = _split_bwd_inputs(case, dtype, cuda)
    ca = xa.shape[-1]
    before = counts()
    da, db = conv_stack.hex_conv_layer_split_dgrad(g, k, ca, radius=2)
    assert _since(before, "hex_conv_layer_split_dgrad",
                  "hex_conv_layer_dgrad") == (2, 0)
    dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=2)
    want = conv_stack.hex_conv_layer_split_dgrad_plain(g, k, ca, radius=2)
    torch.cuda.synchronize()
    assert da.shape == xa.shape and db.shape == xb.shape
    assert da.dtype == db.dtype == dtype
    assert torch.equal(da, dx[..., :ca]) and torch.equal(db, dx[..., ca:])
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert _rel(torch.cat([da, db], -1), torch.cat(want, -1)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_BWD_CASES)
def test_split_wgrad_matches_plain_and_unsplit(cuda, case, dtype):
    """Two dW runs, on (A, g) and on (B, g): bit-equal to the unsplit wgrad
    on each input concatenated along Cin and to a second launch, within
    1e-4 of the plain version."""
    xa, xb, g, k = _split_bwd_inputs(case, dtype, cuda)
    before = counts()
    got = conv_stack.hex_conv_layer_split_wgrad(xa, xb, g, radius=2)
    assert _since(before, "hex_conv_layer_split_wgrad",
                  "hex_conv_layer_wgrad") == (2, 0)
    parts = torch.cat([conv_stack.hex_conv_layer_wgrad(xa, g, radius=2),
                       conv_stack.hex_conv_layer_wgrad(xb, g, radius=2)], 1)
    again = conv_stack.hex_conv_layer_split_wgrad(xa, xb, g, radius=2)
    want = conv_stack.hex_conv_layer_split_wgrad_plain(xa, xb, g, radius=2)
    torch.cuda.synchronize()
    assert got.shape == k.shape and got.dtype == torch.float32
    assert torch.equal(got, parts) and torch.equal(got, again)
    assert _rel(got, want) <= 1e-4


def test_split_backward_refuses_what_it_does_not_take(cuda):
    xa, xb, g, k = _split_bwd_inputs(SPLIT_BWD_CASES[2], torch.float32, cuda)
    with pytest.raises(ValueError, match="0 < ca"):
        conv_stack.hex_conv_layer_split_dgrad(g, k, 0, radius=2)
    with pytest.raises(ValueError, match="0 < ca"):
        conv_stack.hex_conv_layer_split_dgrad(g, k, k.shape[1], radius=2)
    with pytest.raises(ValueError, match="kernel must be"):
        conv_stack.hex_conv_layer_split_dgrad(g, k[:4], 2, radius=2)
    with pytest.raises(ValueError, match="must share"):
        conv_stack.hex_conv_layer_split_wgrad(xa, xb.bfloat16(), g, radius=2)
    with pytest.raises(ValueError, match="must share"):
        conv_stack.hex_conv_layer_split_wgrad(xa, xb, g[:, :5].contiguous(),
                                              radius=2)


def test_hexunet_train_step_on_cuda_goes_through_the_kernels(cuda):
    """A small HexUNet (GN, float32 and bfloat16) trains on the kernels: per
    step 1 plan_gather, 3 kernel-B layers, 2 split layers, 2 dgrad, 4 split
    dgrad, 3 wgrad, 4 split wgrad and 5 GN backward launches, and no other
    kernel; the
    float32 step's loss and every grad within 1e-3 of the plain path, the
    bfloat16 step's loss finite."""
    from hygrid_tpu_torch.models import HexUNet
    gen = torch.Generator(device=cuda).manual_seed(6)
    kw = dict(num_classes=4, widths=(16, 32, 64), norm="GN")
    rect = torch.rand((2, 3, 64, 64), generator=gen, device=cuda)
    labels = torch.randint(0, 4, (2, 32, 32), generator=gen, device=cuda)
    counters = ("plan_gather", "shift_resample", "hex_conv_layer",
                "hex_conv_layer_split", "hex_conv_layer_dgrad",
                "hex_conv_layer_split_dgrad", "hex_conv_layer_wgrad",
                "hex_conv_layer_split_wgrad", "gn_relu_backward",
                "hex_conv_fused_stack", "hex_conv_single")
    want_counts = {"plan_gather": 1, "hex_conv_layer": 3,
                   "hex_conv_layer_split": 2, "hex_conv_layer_dgrad": 2,
                   "hex_conv_layer_split_dgrad": 4, "hex_conv_layer_wgrad": 3,
                   "hex_conv_layer_split_wgrad": 4, "gn_relu_backward": 5}
    for dtype in (torch.float32, torch.bfloat16):
        model = HexUNet(dtype=dtype, generator=gen, **kw)
        ref = HexUNet(**kw)
        ref.load_state_dict(model.state_dict())
        before = counts()
        _, m = train_step(create_train_state(model), hexify_batch(rect),
                          labels)
        launched = dict(zip(counters, _since(before, *counters)))
        assert launched == {name: want_counts.get(name, 0)
                            for name in counters}
        assert math.isfinite(float(m["loss"]))
        if dtype == torch.bfloat16:
            continue
        _, ref_m = train_step(create_train_state(_Plain(ref)),
                              hexify_batch(rect, plain=True), labels)
        assert abs(float(m["loss"]) - float(ref_m["loss"])) \
            <= 1e-3 * abs(float(ref_m["loss"]))
        for (name, p), q in zip(model.named_parameters(), ref.parameters()):
            assert p.grad is not None, name
            assert _rel(p.grad, q.grad) <= 1e-3, name


# ---- kernel B's GN half: stats in the conv epilogue, the GN backward --------

GN_WIDTHS = [63, 64, 127]
GN_COUTS = [16, 32, 64, 128]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", ["1", "8", "Cout"])
@pytest.mark.parametrize("cout", GN_COUTS)
@pytest.mark.parametrize("w", GN_WIDTHS)
def test_gn_layer_stats_epilogue_matches_plain(cuda, w, cout, groups, dtype):
    """A GN layer (statistics summed in the conv epilogue, partial column
    tiles counting real pixels only) against hex_conv_layer_plain: 1e-4
    relative in float32, 3e-2 in bfloat16; a second launch bit-equal."""
    g = {"1": 1, "8": 8, "Cout": cout}[groups]
    gen = torch.Generator(device=cuda).manual_seed(w + cout + g)
    x = torch.rand((2, 5, w, 16), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((cout, 16, 7), generator=gen, device=cuda)
         / math.sqrt(16 * 7)).to(dtype)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    norm = ("gn", g, 1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
            0.1 * torch.randn((cout,), generator=gen, device=cuda))
    kw = dict(radius=2, norm=norm, relu=True)
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer(x, k, bias, **kw)
        again = conv_stack.hex_conv_layer(x, k, bias, **kw)
        want = conv_stack.hex_conv_layer_plain(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 3e-2)


def test_gn_layer_where_a_group_spans_two_channel_tiles(cuda):
    """Radius 4 at Cin = 256, Cout = 128: the bf16 tile halves to N = 64,
    so GN(1)'s group spans two blocks' channels (two segments a group)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    bf = torch.bfloat16
    kn = F.hex_kernel_num(4)
    assert conv_stack._tile_n(bf, 256, 128, kn,
                              *conv_stack._patch_shape(4, 1, False)) == 64
    x = torch.rand((2, 9, 70, 256), generator=gen, device=cuda).to(bf)
    k = (torch.randn((128, 256, kn), generator=gen, device=cuda)
         / math.sqrt(256 * kn)).to(bf)
    norm = ("gn", 1, torch.ones(128, device=cuda),
            torch.zeros(128, device=cuda))
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer(x, k, radius=4, norm=norm, relu=True)
        want = conv_stack.hex_conv_layer_plain(x, k, radius=4, norm=norm,
                                               relu=True)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("w", [63, 127])
def test_gn_split_layer_is_bit_equal_to_the_layer_on_the_concatenation(
        cuda, w, groups, dtype):
    """The split GN layer's epilogue sums depend only on the block's
    geometry, so the split layer equals kernel B on torch.cat bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(w + groups)
    xa = torch.rand((2, 6, w, 24), generator=gen, device=cuda).to(dtype)
    xb = torch.rand((2, 6, w, 40), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((64, 64, 7), generator=gen, device=cuda)
         / math.sqrt(64 * 7)).to(dtype)
    norm = ("gn", groups,
            1 + 0.1 * torch.rand((64,), generator=gen, device=cuda),
            0.1 * torch.randn((64,), generator=gen, device=cuda))
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer_split(xa, xb, k, radius=2, norm=norm,
                                              relu=True)
        cat = conv_stack.hex_conv_layer(torch.cat([xa, xb], -1), k, radius=2,
                                        norm=norm, relu=True)
    torch.cuda.synchronize()
    assert torch.equal(got, cat)


GN_BWD_CASES = [  # (B, H, W, C, G, relu): C off 8 takes the 4- and
    (2, 5, 63, 32, 8, True),         # 1-channel vectors; at G = C, dbias
    (3, 7, 127, 64, 1, True),        # is 0 but for rounding (a group of
    (2, 4, 9, 128, 128, True),       # one channel cancels its bias)
    (2, 4, 9, 128, 16, False),
    (1, 6, 13, 20, 4, True),
    (2, 5, 11, 13, 1, True),
    (2, 3, 5, 24, 3, False),
    # the wave walk's edges (conv_stack.gn_backward_plan): HW under one
    # chunk; b=1; several samples a wave and several waves; C = 8 at G = C;
    # C = 1024 at G = 8 and G = 1; C = 384 (a fold's columns outnumber the
    # block's threads); a sample larger than the card's shared memory
    # (chunks staged in part, the rest read twice); a group whose variance
    # sits at the clamp (one sample's first group constant: f = 0)
    (2, 1, 3, 32, 8, True),
    (1, 64, 63, 128, 8, True),
    (12, 64, 63, 128, 8, True),
    (2, 9, 11, 8, 8, True),
    (2, 9, 11, 1024, 8, True),
    (2, 5, 7, 1024, 1, False),
    (3, 5, 7, 384, 8, True),
    (2, 512, 512, 32, 8, True),
    (3, 6, 9, 16, 4, True, "clamp"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GN_BWD_CASES)
def test_gn_relu_backward_matches_plain(cuda, case, dtype):
    """gn_bwd_wave_kernel against gn_relu_backward_plain on the same saved
    statistics: gpre within 1e-4 relative in float32 (3e-2 in bf16: one
    bf16 rounding of each side), dgamma and dbeta within 1e-4 (both
    float32, other summation orders), dbias within 1e-4 as well, but at
    G = C within 1e-4 of the sum of |gpre| it adds up (its terms cancel
    there: it is 0 but for rounding); a second launch bit-equal."""
    b, h, w, c, g, relu, *clamp = case
    gen = torch.Generator(device=cuda).manual_seed(GN_BWD_CASES.index(case))
    y = 1.5 * torch.randn((b, h, w, c), generator=gen, device=cuda) + 0.2
    if clamp:
        y[min(1, b - 1), ..., :c // g] = 0.5
    gamma = 1 + 0.2 * torch.randn((c,), generator=gen, device=cuda)
    beta = 0.2 * torch.randn((c,), generator=gen, device=cuda)
    gout = torch.randn((b, h, w, c), generator=gen, device=cuda).to(dtype)
    mean, rstd = conv_stack.gn_stats_plain(y, g)
    args = (y, mean, rstd, gamma, beta, gout, g, relu)
    before = counts()
    got = conv_stack.gn_relu_backward(*args)
    again = conv_stack.gn_relu_backward(*args)
    want = conv_stack.gn_relu_backward_plain(*args)
    torch.cuda.synchronize()
    assert _since(before, "gn_relu_backward") == (2,)
    assert got[0].dtype == dtype and got[0].shape == y.shape
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(got[0], want[0]) <= (1e-4 if dtype == torch.float32
                                     else 3e-2)
    for a, b in zip(got[1:3], want[1:3]):
        assert _rel(a, b) <= 1e-4
    if g == c:
        terms = want[0].float().abs().sum((0, 1, 2))
        assert bool(((got[3] - want[3]).abs() <= 1e-4 * terms).all())
    else:
        assert _rel(got[3], want[3]) <= 1e-4
    if clamp:
        assert float(rstd[min(1, y.shape[0] - 1), 0]) == pytest.approx(
            1e-5 ** -0.5)


def _gn_bwd_args(cuda, dtype=torch.bfloat16, shape=(4, 64, 63, 32), g=8):
    gen = torch.Generator(device=cuda).manual_seed(5)
    y = 1.5 * torch.randn(shape, generator=gen, device=cuda) + 0.2
    c = shape[-1]
    gamma = 1 + 0.2 * torch.randn((c,), generator=gen, device=cuda)
    beta = 0.2 * torch.randn((c,), generator=gen, device=cuda)
    gout = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    mean, rstd = conv_stack.gn_stats_plain(y, g)
    return y, mean, rstd, gamma, beta, gout, g, True


def test_gn_relu_backward_is_at_most_two_launches(cuda):
    """One call is one kernel launch and the memset of its counters (the
    statistics read in place from the forward's (B, G, 2) tensor, no stack
    or copy), as torch.profiler sees the device."""
    from torch.profiler import ProfilerActivity, profile
    y, mean, rstd, gamma, beta, gout, g, relu = _gn_bwd_args(cuda)
    stats = torch.stack([mean, rstd], -1).contiguous()
    args = (y, stats[..., 0], stats[..., 1], gamma, beta, gout, g, relu)
    conv_stack.gn_relu_backward(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        conv_stack.gn_relu_backward(*args)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
    assert 1 <= len(device) <= 2, device
    assert sum("gn_bwd_wave_kernel" in n for n in device) == 1, device


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_relu_backward_replays_in_a_cuda_graph(cuda, dtype):
    """A CUDA-graph capture of the backward replays bit-equal to the eager
    call, twice (the counters are cleared on the stream each replay)."""
    args = _gn_bwd_args(cuda, dtype)
    eager = conv_stack.gn_relu_backward(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv_stack.gn_relu_backward(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv_stack.gn_relu_backward(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_gn_relu_backward_raises_where_no_plan_fits(cuda, monkeypatch):
    """No fallback: a card whose blocks cannot stage one pixel raises (the
    planner's limits stood in for), and nothing is launched."""
    args = _gn_bwd_args(cuda, shape=(2, 8, 9, 1024))
    conv_stack.gn_backward_device(cuda)
    index = torch.cuda.current_device()
    monkeypatch.setitem(conv_stack._GN_BWD_DEVICE, index, (132, 4096))
    before = counts()
    with pytest.raises(ValueError, match="cannot stage one pixel"):
        conv_stack.gn_relu_backward(*args)
    assert _since(before, "gn_relu_backward") == (0,)


def test_gn_training_step_runs_no_plain_tail_on_cuda(cuda, monkeypatch):
    """A HexCNN GN training step on CUDA pulls every GN layer back through
    the GN backward kernel (one launch a layer) and never through the plain
    tail."""
    calls = []
    orig = conv_stack._post_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(conv_stack, "_post_plain", spy)
    gen = torch.Generator(device=cuda).manual_seed(3)
    model = HexCNN(channels=(16, 32), depth=2, norm="GN",
                   dtype=torch.bfloat16, device=cuda, generator=gen)
    images = hexify_batch(torch.rand((2, 3, 64, 64), generator=gen,
                                     device=cuda))
    before = counts()
    _, m = train_step(create_train_state(model), images,
                      torch.tensor([1, 4], device=cuda))
    assert _since(before, "gn_relu_backward") == (4,)
    assert not calls
    assert math.isfinite(float(m["loss"]))


AFFINE_BWD_CASES = [  # (B, H, W, Ca, Cb, Cout, relu); Cb 0: not split
    (2, 11, 13, 5, 0, 40, True),
    (2, 12, 9, 32, 0, 32, False),
    (2, 10, 17, 16, 16, 16, True),
    (1, 9, 70, 24, 8, 32, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", AFFINE_BWD_CASES)
def test_affine_layer_backward_matches_plain(cuda, case, dtype):
    """An affine layer (and an affine split layer) under grad: the forward
    keeps its float32 pre-activation, the backward runs the dgrad and dW
    kernels (split dgrad and split wgrad for the split layer); grads of x,
    the kernel, bias, scale and shift against autograd of the plain version
    (float32 1e-4 relative; bfloat16 3e-2, the conv layer's), and two
    backward runs bit-equal."""
    b, h, w, ca, cb, cout, relu = case
    gen = torch.Generator(device=cuda).manual_seed(AFFINE_BWD_CASES.index(case))
    split = cb > 0
    xs = [torch.rand((b, h, w, c), generator=gen, device=cuda).to(dtype)
          for c in ((ca, cb) if split else (ca,))]
    k = (torch.randn((cout, ca + cb, 7), generator=gen, device=cuda)
         / math.sqrt((ca + cb) * 7)).to(dtype)
    vecs = [0.1 * torch.randn((cout,), generator=gen, device=cuda),
            1 + 0.2 * torch.randn((cout,), generator=gen, device=cuda),
            0.1 * torch.randn((cout,), generator=gen, device=cuda)]
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda).to(dtype)

    def run(plain):
        leaves = [t.clone().requires_grad_() for t in (*xs, k, *vecs)]
        xl, (kl, bias, scale, shift) = leaves[:len(xs)], leaves[len(xs):]
        kw = dict(radius=2, norm=("affine", scale, shift), relu=relu)
        if split:
            fn = (conv_stack.hex_conv_layer_split_plain if plain
                  else conv_stack.hex_conv_layer_split)
        else:
            fn = (conv_stack.hex_conv_layer_plain if plain
                  else conv_stack.hex_conv_layer)
        (fn(*xl, kl, bias, **kw) * g).sum().backward()
        return [t.grad for t in leaves]

    counters = ("hex_conv_layer", "hex_conv_layer_dgrad",
                "hex_conv_layer_wgrad", "hex_conv_layer_split",
                "hex_conv_layer_split_dgrad", "hex_conv_layer_split_wgrad")
    before = counts()
    got, again = run(False), run(False)
    want = run(True)
    launches = dict(zip(counters, _since(before, *counters)))
    want_launches = ({"hex_conv_layer_split": 2,
                      "hex_conv_layer_split_dgrad": 4,
                      "hex_conv_layer_split_wgrad": 4} if split else
                     {"hex_conv_layer": 2, "hex_conv_layer_dgrad": 2,
                      "hex_conv_layer_wgrad": 2})
    assert launches == {n: want_launches.get(n, 0) for n in counters}
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for i, (u, v, wv) in enumerate(zip(got, again, want)):
        assert torch.equal(u, v), i
        assert _rel(u, wv) <= tol, i


def test_hexvit_on_cuda_serves_through_plan_gather_alone(cuda):
    """A small HexViT (bf16) on hexify_batch's output: one plan_gather a
    request and no other hand-written kernel; logits within 5e-2 of the
    plain float32 path."""
    from hygrid_tpu_torch.models import HexViT
    gen = torch.Generator(device=cuda).manual_seed(4)
    kw = dict(num_classes=5, dim=64, depth=2, heads=2, patch_halvings=3,
              hex_size=(32, 32))
    model = HexViT(dtype=torch.bfloat16, device=cuda, generator=gen, **kw)
    ref = HexViT(device=cuda, **kw)
    ref.load_state_dict(model.state_dict())
    rect = torch.rand((2, 3, 64, 64), generator=gen, device=cuda)
    before = counts()
    with torch.inference_mode():
        out = model(hexify_batch(rect.to(torch.bfloat16)))
    assert _since(before, "plan_gather", "hex_conv_layer", "hex_conv_single",
                  "shift_resample") == (1, 0, 0, 0)
    want = ref(hexify_batch(rect, plain=True))
    assert out.shape == (2, 5) and out.dtype == torch.bfloat16
    assert _rel(out, want) <= 5e-2


def _op_cases(cuda):
    """Each ``hygrid`` op's arguments on the card at small sizes, in
    float32 and bfloat16 and in every table form: name -> (op, args)."""
    gen = torch.Generator(device=cuda).manual_seed(16)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    plans = {"parity-factored": geometry.rect_to_hex_plan(16, 20, 8, 10,
                                                          "bilinear"),
             "rows": geometry.hex_to_rect_plan(8, 10, 16, 20, "linear"),
             "dense": geometry.warp_plan(12, 14, np.array(
                 [[1.2, 0.1, 0.0], [-0.1, 0.9, 0.0], [0.0, 0.0, 1.0]]),
                 "linear")}
    shifts = {"phase": plans["parity-factored"],
              "select": render._mosaic_sample_plan(17, 30, 68, 120, 0, None),
              "dense": geometry.hex_to_rect_plan(70, 8, 150, 8, "linear")}
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for name, plan in plans.items():
            cases[f"plan_gather-{name}-{tag}"] = (
                torch.ops.hygrid.plan_gather, resample._op_args(
                    rand(2, 3, *plan.src_shape, dtype=dt), plan))
        for name, plan in shifts.items():
            geo = resample_shift.shift_decompose_cached(plan)
            cases[f"shift_resample-{name}-{tag}"] = (
                torch.ops.hygrid.shift_resample,
                (rand(2, *plan.src_shape, dtype=dt),
                 *resample_shift._op_args(plan, geo, cuda)))
        cases[f"hex_conv_single-{tag}"] = (
            torch.ops.hygrid.hex_conv_single,
            (rand(2, 16, 10, 12, dtype=dt), rand(32, 16, 7, dtype=dt), 1, 2,
             1))
        for kind, split in (("gn", False), ("affine", False), (None, False),
                            ("gn", True)):
            cin = 24 if split else 16
            p, q = (rand(32) + 1, rand(32)) if kind else (None, None)
            cases[f"hex_conv_layer-{kind}-{'split-' if split else ''}{tag}"] \
                = (torch.ops.hygrid.hex_conv_layer,
                   (rand(2, 6, 7, 16, dtype=dt),
                    rand(2, 6, 7, 8, dtype=dt) if split else None,
                    rand(32, cin, 7, dtype=dt) * 0.2, rand(32), p, q, 2, 1,
                    kind, 8 if kind == "gn" else 0, True, kind == "affine"))
        cases[f"hex_conv_fused_stack-{tag}"] = (
            torch.ops.hygrid.hex_conv_fused_stack,
            (rand(2, 6, 7, 16, dtype=dt),
             [rand(16, 16, 7, dtype=dt) * 0.2 for _ in range(2)],
             [rand(16), None], 2, 1, [True, False]))
        for mask in (False, True):
            cases[f"hex_max_pool-{'mask' if mask else 'values'}-{tag}"] = (
                torch.ops.hygrid.hex_max_pool,
                (rand(2, 7, 9, 16, dtype=dt), 2, 2, 2, 2, mask))
        x = rand(2, 7, 9, 16, dtype=dt)
        cases[f"hex_max_pool_backward-{tag}"] = (
            torch.ops.hygrid.hex_max_pool_backward,
            (rand(2, 3, 4, 16, dtype=dt),
             torch.ops.hygrid.hex_max_pool(x, 2, 2, 2, 2, True)[1], 7, 9, 2,
             2, 2, 2))
    return cases


OP_CASE_NAMES = [f"{op}-{form}-{tag}" for tag in ("f32", "bf16")
                 for op, form in (
                     *((("plan_gather", f) for f in
                        ("parity-factored", "rows", "dense"))),
                     *((("shift_resample", f) for f in
                        ("phase", "select", "dense"))))] + [
    f"{name}-{tag}" for tag in ("f32", "bf16")
    for name in ("hex_conv_single", "hex_conv_layer-gn",
                 "hex_conv_layer-affine", "hex_conv_layer-None",
                 "hex_conv_layer-gn-split", "hex_conv_fused_stack",
                 "hex_max_pool-values", "hex_max_pool-mask",
                 "hex_max_pool_backward")]


@pytest.mark.parametrize("name", OP_CASE_NAMES)
def test_hygrid_op_on_cuda_matches_its_schema_and_fake(cuda, name):
    """``torch.library.opcheck`` of each ``hygrid`` op on the card: the
    launch keeps the schema (no input mutated, no output aliased) and the
    fake implementation gives its outputs' shapes, dtypes and strides."""
    op, args = _op_cases(cuda)[name]
    torch.library.opcheck(op.default, args,
                          test_utils=("test_schema", "test_faketensor"))


def test_exported_hexcnn_runs_the_kernels_on_cuda(cuda, tmp_path):
    """``utils/export.py`` on the card: hexcnn_tiny (GN) exported with a
    symbolic batch, saved, loaded and run at b = 1 and 3 launches one
    plan_gather and two hex_conv_layer a call, ``torch.equal`` to the
    eager kernel path; the same weights exported on the CPU and moved to
    the card at load run the same kernels to the same bits."""
    from hygrid_tpu_torch.utils import export as texp
    gen = torch.Generator(device=cuda).manual_seed(17)
    model = hexcnn_tiny(num_classes=5, norm="GN", dtype=torch.bfloat16,
                        device=cuda, generator=gen).eval()
    cpu_model = hexcnn_tiny(num_classes=5, norm="GN", dtype=torch.bfloat16,
                            device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    x = torch.rand((2, 3, 32, 32), generator=gen, device=cuda)
    paths = []
    for name, m, ex, kw in (("cuda", model, x, {}),
                            ("cpu", cpu_model, x.cpu(),
                             dict(platforms=("cpu", "cuda")))):
        paths.append(str(tmp_path / f"{name}.pt2"))
        texp.save_exported(paths[-1], texp.export_inference(
            m, None, ex.to(torch.bfloat16), symbolic_batch=True, **kw))
    for program in (texp.load_exported(paths[0]),
                    texp.load_exported(paths[1], device="cuda")):
        for b in (1, 3):
            xb = torch.rand((b, 3, 32, 32), generator=gen,
                            device=cuda).to(torch.bfloat16)
            before = counts()
            with torch.inference_mode():
                got = program(xb)
            assert _since(before, "plan_gather", "hex_conv_layer") == (1, 2)
            with torch.inference_mode():
                assert torch.equal(got, model(hexify_batch(xb)))


# ---- the float32 conv passes' tiles at their edges --------------------------
#
# Kernel B's CUDA-core tile (hex_common.cuh::conv_tile: 4 or 8 output rows x
# 64 columns x 16, 32 or 64 channels, 16-channel input chunks) and the
# float32 dW (hex_conv_wgrad.cu::wgrad_partial_kernel: a warp a tap, 8 x 8
# channels a thread) where their shapes do not divide: Cin = 3 and Cin off
# 4 and 16 (element-wise copies, a short last chunk), W off the 64-column
# strip, odd H (a band past the image), Cout off the channel tile.

F32_EDGE_CASES = [  # (B, H, W, Cin, Cout, radius)
    (2, 9, 70, 3, 32, 2),      # the stem's 3 channels; W one strip + 6
    (1, 11, 65, 6, 40, 2),     # Cin off 4; Cout over 32, off 64
    (2, 7, 33, 18, 21, 2),     # two chunks, the last of 2; Cout off 4
    (1, 13, 129, 35, 64, 2),   # three chunks, the last of 3; 2 strips + 1
    (2, 5, 64, 16, 16, 2),     # one chunk, the 16-channel tile
    (1, 9, 40, 37, 130, 3),    # radius 3; three 64-channel tiles
]


def _f32_edge_inputs(case, cuda):
    b, h, w, cin, cout, r = case
    gen = torch.Generator(device=cuda).manual_seed(
        100 + F32_EDGE_CASES.index(case))
    kn = 3 * r * r - 3 * r + 1
    x = torch.rand((b, h, w, cin), generator=gen, device=cuda)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda)
    k = torch.randn((cout, cin, kn), generator=gen, device=cuda) \
        / math.sqrt(cin * kn)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    norm = ("gn", math.gcd(8, cout),
            1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
            0.1 * torch.randn((cout,), generator=gen, device=cuda))
    return x, g, k, bias, norm, r


@pytest.mark.parametrize("norm_kind", [None, "gn"])
@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_f32_conv_pass_at_its_edges_matches_plain(cuda, case, norm_kind):
    """The float32 conv pass against its plain version (1e-5 absolute
    without a norm, 1e-4 relative with GN, whose statistics come from the
    epilogue's per-row sums), a second launch bit-equal."""
    x, _, k, bias, norm, r = _f32_edge_inputs(case, cuda)
    kw = dict(radius=r, norm=norm if norm_kind else None, relu=True)
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer(x, k, bias, **kw)
        again = conv_stack.hex_conv_layer(x, k, bias, **kw)
        want = conv_stack.hex_conv_layer_plain(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    if norm_kind:
        assert _rel(got, want) <= 1e-4
    else:
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_f32_dgrad_at_its_edges_matches_plain(cuda, case):
    """dx in float32 (the conv pass on the adjoint taps): 1e-5 relative,
    as the dgrad tests hold it."""
    x, g, k, _, _, r = _f32_edge_inputs(case, cuda)
    got = conv_stack.hex_conv_layer_dgrad(g, k, radius=r)
    want = conv_stack.hex_conv_layer_dgrad_plain(g, k, radius=r)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_f32_wgrad_at_its_edges_matches_plain_and_a_second_launch(cuda,
                                                                   case):
    x, g, k, _, _, r = _f32_edge_inputs(case, cuda)
    got = conv_stack.hex_conv_layer_wgrad(x, g, radius=r)
    again = conv_stack.hex_conv_layer_wgrad(x, g, radius=r)
    want = conv_stack.hex_conv_layer_wgrad_plain(x, g, radius=r)
    torch.cuda.synchronize()
    assert got.shape == k.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("cb", [8, 21])
@pytest.mark.parametrize("norm_kind", [None, "gn"])
def test_f32_split_at_ca_24_is_bit_equal_to_the_concatenation(cuda,
                                                              norm_kind, cb):
    """The split layer at Ca = 24 (its second 16-channel chunk straddles
    Ca; Cb = 21 off the 4-channel unit), forward and backward in float32:
    bit-equal to the layer on the concatenation, to the dgrad cut at Ca and
    to the dW on each input; the plain versions' tolerances."""
    gen = torch.Generator(device=cuda).manual_seed(cb)
    b, h, w, ca, cout = 2, 9, 70, 24, 40
    xa = torch.rand((b, h, w, ca), generator=gen, device=cuda)
    xb = torch.rand((b, h, w, cb), generator=gen, device=cuda)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda)
    k = torch.randn((cout, ca + cb, 7), generator=gen, device=cuda) \
        / math.sqrt((ca + cb) * 7)
    norm = None
    if norm_kind:
        norm = ("gn", 8,
                1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    kw = dict(radius=2, norm=norm, relu=True)
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer_split(xa, xb, k, **kw)
        cat = conv_stack.hex_conv_layer(torch.cat([xa, xb], -1), k, **kw)
        want = conv_stack.hex_conv_layer_split_plain(xa, xb, k, **kw)
    da, db = conv_stack.hex_conv_layer_split_dgrad(g, k, ca, radius=2)
    dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=2)
    dw = conv_stack.hex_conv_layer_split_wgrad(xa, xb, g, radius=2)
    parts = torch.cat([conv_stack.hex_conv_layer_wgrad(xa, g, radius=2),
                       conv_stack.hex_conv_layer_wgrad(xb, g, radius=2)], 1)
    dw_want = conv_stack.hex_conv_layer_split_wgrad_plain(xa, xb, g,
                                                          radius=2)
    torch.cuda.synchronize()
    assert torch.equal(got, cat)
    if norm_kind:
        assert _rel(got, want) <= 1e-4
    else:
        assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(da, dx[..., :ca]) and torch.equal(db, dx[..., ca:])
    assert torch.equal(dw, parts)
    assert _rel(dw, dw_want) <= 1e-4


@pytest.mark.parametrize("c", [16, 14])
def test_f32_fused_stack_at_c16_stages_one_layers_weights(cuda, c):
    """C <= 16 in float32: one input chunk, the 16-channel tile (8 rows x
    64 columns, 256 threads), a layer's weights staged once a block; the
    stack bit-equal to chained layers and within 1e-4 of the plain
    version, at C = 16 (16-byte copies) and C = 14 (element-wise)."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.rand((3, 19, 70, c), generator=gen, device=cuda)
    ks = [torch.randn((c, c, 7), generator=gen, device=cuda)
          / math.sqrt(c * 7) for _ in range(4)]
    bs = [0.1 * torch.randn((c,), generator=gen, device=cuda)
          for _ in range(4)]
    relus = [True, True, True, False]
    got = conv_stack.hex_conv_fused_stack(x, ks, bs, radius=2, relus=relus)
    plan = dict(conv_stack.LAST_FUSED_PLAN)
    chained = x
    for k, b, relu in zip(ks, bs, relus):
        chained = conv_stack.hex_conv_layer(chained, k, b, radius=2,
                                            relu=relu)
    want = conv_stack.hex_conv_fused_stack_plain(x, ks, bs, radius=2,
                                                 relus=relus)
    torch.cuda.synchronize()
    assert torch.equal(got, chained)
    assert _rel(got, want) <= 1e-4
    assert (plan["n"], plan["rows"], plan["threads"], plan["weights"]) == \
        (16, 8, 256, "layer")
    assert plan["smem"] <= conv_stack._MMA_MAX_SMEM


# ---- the float32 conv passes at a wide dilation -----------------------------
#
# The patch a float32 tile stages grows with the rows its taps reach (2 d + 1
# at radius 2, dilation d).  Where a tile of all the taps does not fit in a
# block's shared memory, kernel B's tile takes the taps in groups, a stage
# each (the same order of products), and the dW takes fewer taps a block.

F32_WIDE_CASES = [  # (B, H, W, Cin, Cout, radius, dilation)
    (2, 24, 66, 35, 24, 2, 10),    # dW 5 taps a block; the conv whole
    (1, 40, 80, 48, 64, 2, 16),    # conv, dx and dW in groups of 5 taps
    (1, 70, 90, 20, 40, 2, 30),    # one tap a group and a block
    (1, 30, 70, 40, 48, 3, 8),     # radius 3: 16 taps a group
]


def _wide_plans_split_taps(case):
    """Which of the float32 conv, dx and dW of a wide case take fewer taps
    a group or a block than the patch of dilation 1 lets them."""
    _, _, _, cin, cout, r, d = case
    kn = 3 * r * r - 3 * r + 1
    conv = conv_stack._f32_tile(cin, cout, conv_stack._tap_rows(r, d, False),
                                conv_stack._patch_shape(r, d, False)[1])
    dx = conv_stack._f32_tile(cout, cin, conv_stack._tap_rows(r, d, True),
                              conv_stack._patch_shape(r, d, True)[1])
    dw = conv_stack._wgrad_f32_plan(cin, cout,
                                    conv_stack._tap_rows(r, d, False),
                                    conv_stack._patch_shape(r, d, False)[1])
    most = conv_stack._wgrad_tile(torch.float32, cin, cout, kn)[2]
    return conv["taps"] < kn, dx["taps"] < kn, dw["taps"] < most


@pytest.mark.parametrize("norm_kind", [None, "gn"])
@pytest.mark.parametrize("case", F32_WIDE_CASES)
def test_f32_passes_at_a_wide_dilation_match_plain(cuda, case, norm_kind):
    """The float32 conv pass, dx and dW where the patch of all the taps
    does not fit: each against its plain version (the edge tests'
    tolerances), a second launch of the conv pass and of dW bit-equal."""
    b, h, w, cin, cout, r, d = case
    kn = 3 * r * r - 3 * r + 1
    assert any(_wide_plans_split_taps(case))
    gen = torch.Generator(device=cuda).manual_seed(200 + d)
    x = torch.rand((b, h, w, cin), generator=gen, device=cuda)
    g = torch.randn((b, h, w, cout), generator=gen, device=cuda)
    k = torch.randn((cout, cin, kn), generator=gen, device=cuda) \
        / math.sqrt(cin * kn)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=cuda)
    norm = None
    if norm_kind:
        norm = ("gn", 8,
                1 + 0.1 * torch.rand((cout,), generator=gen, device=cuda),
                0.1 * torch.randn((cout,), generator=gen, device=cuda))
    kw = dict(radius=r, dilation=d, norm=norm, relu=True)
    with torch.inference_mode():
        got = conv_stack.hex_conv_layer(x, k, bias, **kw)
        again = conv_stack.hex_conv_layer(x, k, bias, **kw)
        want = conv_stack.hex_conv_layer_plain(x, k, bias, **kw)
    dx = conv_stack.hex_conv_layer_dgrad(g, k, radius=r, dilation=d)
    dx_want = conv_stack.hex_conv_layer_dgrad_plain(g, k, radius=r,
                                                    dilation=d)
    dw = conv_stack.hex_conv_layer_wgrad(x, g, radius=r, dilation=d)
    dw_again = conv_stack.hex_conv_layer_wgrad(x, g, radius=r, dilation=d)
    dw_want = conv_stack.hex_conv_layer_wgrad_plain(x, g, radius=r,
                                                    dilation=d)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if norm_kind:
        assert _rel(got, want) <= 1e-4
    else:
        assert float((got - want).abs().max()) <= 1e-5
    assert _rel(dx, dx_want) <= 1e-5
    assert torch.equal(dw, dw_again)
    assert _rel(dw, dw_want) <= 1e-4


def test_f32_fused_stack_at_a_wide_dilation_equals_chained_layers(cuda):
    """C = 32 at radius 2, dilation 16: the fused stack's tile takes its
    taps in groups (the weights staged a chunk at a time) and stays
    bit-equal to chained layers."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    c, d = 32, 16
    x = torch.rand((2, 40, 80, c), generator=gen, device=cuda)
    ks = [torch.randn((c, c, 7), generator=gen, device=cuda)
          / math.sqrt(c * 7) for _ in range(3)]
    bs = [0.1 * torch.randn((c,), generator=gen, device=cuda)
          for _ in range(3)]
    relus = [True, True, False]
    got = conv_stack.hex_conv_fused_stack(x, ks, bs, radius=2, dilation=d,
                                          relus=relus)
    plan = dict(conv_stack.LAST_FUSED_PLAN)
    chained = x
    for k, b, relu in zip(ks, bs, relus):
        chained = conv_stack.hex_conv_layer(chained, k, b, radius=2,
                                            dilation=d, relu=relu)
    want = conv_stack.hex_conv_fused_stack_plain(x, ks, bs, radius=2,
                                                 dilation=d, relus=relus)
    torch.cuda.synchronize()
    assert torch.equal(got, chained)
    assert _rel(got, want) <= 1e-4
    tile = conv_stack._f32_tile(c, c, conv_stack._tap_rows(2, d, False),
                                conv_stack._patch_shape(2, d, False)[1])
    assert tile["taps"] < 7
    assert (plan["n"], plan["rows"], plan["smem"]) == \
        (tile["cob"], tile["rows"], tile["smem"])


# ---- the hex max-pool (csrc/hex_pool.cu) ------------------------------------

POOL_CASES = [  # (B, H, W, C), (kh, kw), stride
    ((2, 256, 256, 32), (2, 2), 2),   # the models' first pool
    ((2, 128, 127, 64), (2, 2), 2),   # their second
    ((1, 9, 10, 3), (2, 2), 2),       # C off a 16-byte unit: a value a thread
    ((2, 7, 11, 8), (1, 2), 2),
    ((2, 8, 13, 16), (2, 1), 3),
    ((1, 11, 12, 24), (2, 2), 3),
    ((3, 5, 7, 4), (1, 2), 3),
]


def _pool_bits(t):
    t = torch.where(torch.isnan(t), torch.nan, t)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _plain_max_pool(x, kernel, stride):
    """``hex_pool2d``'s plain path (``_window_reduce``) on NHWC ``x``."""
    (kh, kw), (sh, sw) = kernel, stride
    hn, wn = pool.pool_shape(x.shape[1], x.shape[2], kh, kw, sh, sw)
    return F._window_reduce(x.permute(0, 3, 1, 2), "max", hn, wn, kh, kw, sh,
                            sw, sw // 2, True)


def _pool_input(case, dtype, cuda):
    shape, _, _ = case
    gen = torch.Generator(device=cuda).manual_seed(POOL_CASES.index(case))
    x = torch.clamp(torch.round(torch.randn(shape, generator=gen,
                                            device=cuda) * 2) / 2, min=0)
    x = x.to(dtype)
    x[0, 0, 0, 0] = float("nan")
    x[0, 2:4, 1:3, -1] = float("nan")           # an all-NaN window
    x[-1, 1, 2, 0] = float("inf")
    x[-1, 0, 1, -1] = -float("inf")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", POOL_CASES)
def test_hex_max_pool_is_bit_equal_to_the_plain_path(cuda, case, dtype):
    """Forward and backward, with NaN cells, an all-NaN window, +-inf and
    the cells no window covers; one launch each."""
    shape, kernel, s = case
    x = _pool_input(case, dtype, cuda)
    t = x.clone().requires_grad_()
    want = _plain_max_pool(t, kernel, (s, s))
    cot = torch.randn(want.shape, generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(dtype)
    cot[0, 0, 0, 0] = float("inf")
    want.backward(cot)
    k = x.clone().requires_grad_()
    before = counts()
    got = pool.hex_max_pool(k, kernel, (s, s))
    got.backward(cot)
    torch.cuda.synchronize()
    assert _since(before, "hex_max_pool", "hex_max_pool_backward") == (1, 1)
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want.detach())
    assert torch.equal(_pool_bits(k.grad), _pool_bits(t.grad))
    with torch.inference_mode():
        assert torch.equal(pool.hex_max_pool(x, kernel, (s, s)), got.detach())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", POOL_CASES)
def test_hex_max_pool_backward_is_differentiable_on_cuda(cuda, case, dtype):
    """A gradient penalty through ``hex_pool2d``'s kernel route: the
    gradient bit-equal to the plain path's, the second-order gradient
    equal in value; the backward kernel launched once."""
    from test_torch_pool import second_order
    shape, kernel, s = case
    x = _pool_input(case, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    hn, wn = pool.pool_shape(shape[1], shape[2], *kernel, s, s)
    cot = torch.randn((shape[0], hn, wn, shape[3]), generator=gen,
                      device=cuda).to(dtype)
    weight = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    want_dx, want = second_order(
        lambda t: _plain_max_pool(t, kernel, (s, s)), x, cot, weight)
    before = counts()
    got_dx, got = second_order(
        lambda t: F.hex_pool2d(t, "max", kernel_size=kernel, stride=s,
                               data_format="NHWC"), x, cot, weight)
    torch.cuda.synchronize()
    assert _since(before, "hex_max_pool", "hex_max_pool_backward") == (1, 1)
    assert torch.equal(_pool_bits(got_dx), _pool_bits(want_dx))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["nchw", "min", "average", "padding",
                                  "ceil_mode", "overlapping", "3-wide",
                                  "float64"])
def test_pools_the_kernel_does_not_take_stay_plain_on_cuda(cuda, name):
    from test_torch_pool import plain_route_case
    before = counts()
    got, want = plain_route_case(name, cuda)
    assert _since(before, "hex_max_pool") == (0,)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _model_pool_launches(model, images, labels):
    """(pool launches of a forward under inference_mode, of a train step)."""
    before = counts()
    with torch.inference_mode():
        model.eval()(images)
    serve = _since(before, "hex_max_pool", "hex_max_pool_backward")
    before = counts()
    train_step(create_train_state(model.train()), images, labels)
    return serve, _since(before, "hex_max_pool", "hex_max_pool_backward")


def test_models_pool_through_the_kernel(cuda):
    """The stacked route's two max-pools a forward, two and their two
    backward launches a training step, in HexCNN and HexUNet."""
    from hygrid_tpu_torch.models import HexUNet
    gen = torch.Generator(device=cuda).manual_seed(21)
    images = hexify_batch(torch.rand((2, 3, 64, 64), generator=gen,
                                     device=cuda))
    cnn = HexCNN(channels=(16, 32, 64), depth=1, norm="GN", generator=gen)
    assert _model_pool_launches(cnn, images, torch.arange(2, device=cuda)) \
        == ((2, 0), (2, 2))
    unet = HexUNet(num_classes=4, widths=(16, 32, 64), norm="GN",
                   generator=gen)
    labels = torch.randint(0, 4, (2, 32, 32), generator=gen, device=cuda)
    assert _model_pool_launches(unet, images, labels) == ((2, 0), (2, 2))


def test_hexcnn_small_train_step_is_bit_equal_with_the_plain_pool(
        cuda, monkeypatch):
    """One float32 training step of HexCNN-small at b=4 (512^2 RGB): the
    loss and every gradient bit for bit the same through the kernel and
    through the plain pool."""
    from hygrid_tpu_torch.models import hexcnn_small
    gen = torch.Generator(device=cuda).manual_seed(22)
    rect = torch.rand((4, 3, 512, 512), generator=gen, device=cuda)
    labels = torch.arange(4, device=cuda) % 10
    models, losses = [], []
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(pool, "hex_max_pool", _plain_max_pool)
        model = hexcnn_small(norm="GN", generator=torch.Generator(
            device=cuda).manual_seed(23))
        before = counts()
        _, m = train_step(create_train_state(model), hexify_batch(rect),
                          labels)
        torch.cuda.synchronize()
        launched = _since(before, "hex_max_pool", "hex_max_pool_backward")
        assert launched == ((2, 2) if route == "kernel" else (0, 0))
        models.append(model)
        losses.append(m["loss"])
    assert torch.equal(_pool_bits(losses[0]), _pool_bits(losses[1]))
    for (name, p), q in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(_pool_bits(p.grad), _pool_bits(q.grad)), name
        assert torch.equal(p, q), name


def test_exported_hexcnn_small_keeps_the_pool_kernel(cuda, tmp_path):
    """HexCNN-small (GN, bf16) exported on the card with a symbolic batch
    keeps its two pools as ``hygrid.hex_max_pool`` nodes; the loaded
    program launches them and equals the eager model at b = 1 and 3."""
    from hygrid_tpu_torch.models import hexcnn_small
    from hygrid_tpu_torch.utils import export as texp
    gen = torch.Generator(device=cuda).manual_seed(24)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16,
                         generator=gen).eval()
    x = torch.rand((2, 3, 512, 512), generator=gen,
                   device=cuda).to(torch.bfloat16)
    exp = texp.export_inference(model, None, x, symbolic_batch=True)
    nodes = [n for n in exp.program.graph.nodes if n.op == "call_function"
             and n.target == torch.ops.hygrid.hex_max_pool.default]
    assert len(nodes) == 2
    path = str(tmp_path / "hexcnn_small.pt2")
    texp.save_exported(path, exp)
    program = texp.load_exported(path)
    for b in (1, 3):
        xb = torch.rand((b, 3, 512, 512), generator=gen,
                        device=cuda).to(torch.bfloat16)
        before = counts()
        with torch.inference_mode():
            got = program(xb)
        assert _since(before, "plan_gather", "hex_conv_layer",
                      "hex_max_pool") == (1, 6, 2)
        with torch.inference_mode():
            assert torch.equal(got, model(hexify_batch(xb)))
