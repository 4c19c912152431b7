"""The HexUNet serving slice on the CPU: hygrid_tpu's flax HexUNet and the
port's, the same weights carried by ``hexunet_state_dict_from_flax``; the
skip-join stage (``HexConvStack(extra=)``) and the split layer's plain
version (``hex_conv_layer_split_plain``) against the reference's Pallas
split kernel in interpret mode and its XLA twin.

Float32; relative max-abs error <= 1e-4 (GroupNorm and BN rescale the
convs' summation-order differences).  Flax runs under ``jax.jit`` on
variables drawn from numpy seeds (``jax.eval_shape``, no flax init), with
``stack_min_cells=10**9`` (its XLA chain) except where a test says it
reaches the interpreted split kernel.
"""
import jax
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu.models import hexunet as jhexunet
from hygrid_tpu.nn.layers import HexConvStack as JHexConvStack
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.nn import HexConvStack
from hygrid_tpu_torch.nn.functional import hex_kernel_num
from hygrid_tpu_torch.utils import hexunet_state_dict_from_flax
from test_torch_modules import random_flax_variables

REL = 1e-4


def _rel_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# ---- the split layer and hex_conv_stack(extra_input=) -----------------------

def _split_inputs(seed, b, h, w, ca, cb, cout, depth, norm_kind):
    rng = np.random.default_rng(seed)
    kn = hex_kernel_num(2)
    xa = rng.random((b, h, w, ca)).astype(np.float32)
    xb = rng.random((b, h, w, cb)).astype(np.float32)
    kernels = [rng.normal(0, 1 / np.sqrt(kn * (ca + cb if i == 0 else cout)),
                          (cout, ca + cb if i == 0 else cout, kn)
                          ).astype(np.float32) for i in range(depth)]
    biases = norms = None
    if norm_kind is None:
        biases = [rng.normal(0, 0.1, cout).astype(np.float32)
                  for _ in kernels]
    else:
        norms = [("gn", 4, 1 + 0.2 * rng.random(cout).astype(np.float32),
                  rng.normal(0, 0.2, cout).astype(np.float32))
                 for _ in kernels]
    return xa, xb, kernels, biases, norms


def _torch_args(kernels, biases, norms):
    tk = [_t(k) for k in kernels]
    tb = None if biases is None else [_t(b) for b in biases]
    tn = None if norms is None else [(n[0], n[1], _t(n[2]), _t(n[3]))
                                     for n in norms]
    return tk, tb, tn


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
@pytest.mark.parametrize("norm_kind", [None, "gn"])
def test_split_stack_matches_pallas_split_kernel(norm_kind, data_format):
    """b=2, 8x8, 8+8 -> 8, 2 layers: hex_conv_stack_pallas(extra_input=)
    runs the TPU split kernel (#10 split=True) in interpret mode."""
    xa, xb, ks, bs, ns = _split_inputs(0, 2, 8, 8, 8, 8, 8, 2, norm_kind)
    if data_format == "NCHW":
        xa, xb = xa.transpose(0, 3, 1, 2), xb.transpose(0, 3, 1, 2)
    want = jcp.hex_conv_stack_pallas(xa, ks, bs, radius=2, norms=ns,
                                     data_format=data_format, extra_input=xb)
    tk, tb, tn = _torch_args(ks, bs, ns)
    got = tcs.hex_conv_stack(_t(xa), tk, tb, radius=2, norms=tn,
                             data_format=data_format, extra_input=_t(xb))
    assert _rel_err(got, want) <= REL
    plain = tcs.hex_conv_stack(_t(xa), tk, tb, radius=2, norms=tn,
                               data_format=data_format, extra_input=_t(xb),
                               plain=True)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("ca,cb", [(24, 8), (5, 11), (16, 16)])
def test_split_stack_matches_xla_twin_at_any_split(ca, cb):
    """Splits the TPU kernel does not take (Ca != Cb, or != Cout) run the
    reference's XLA twin; the port runs its split layer for all."""
    xa, xb, ks, bs, ns = _split_inputs(ca, 2, 10, 9, ca, cb, 16, 2, "gn")
    want = jcp.hex_conv_stack_pallas(xa, ks, bs, radius=2, norms=ns,
                                     data_format="NHWC", extra_input=xb)
    tk, tb, tn = _torch_args(ks, bs, ns)
    got = tcs.hex_conv_stack(_t(xa), tk, tb, radius=2, norms=tn,
                             data_format="NHWC", extra_input=_t(xb))
    assert _rel_err(got, want) <= REL


def test_split_layer_plain_is_the_layer_on_the_concatenation():
    xa, xb, ks, bs, _ = _split_inputs(3, 1, 6, 7, 24, 8, 8, 1, None)
    a, b, k, bias = _t(xa), _t(xb), _t(ks[0]), _t(bs[0])
    got = tcs.hex_conv_layer_split(a, b, k, bias, radius=2, relu=True)
    want = tcs.hex_conv_layer(torch.cat([a, b], -1), k, bias, radius=2,
                              relu=True)
    assert torch.equal(got, want)
    assert torch.equal(tcs.hex_conv_layer_split_plain(
        a, b, k, bias, radius=2, relu=True), want)


def _guard_cases():
    x = np.zeros((1, 8, 8, 8), np.float32)
    ks = [np.zeros((8, 16, 7), np.float32), np.zeros((8, 8, 7), np.float32)]
    return x, ks, {
        "fused": dict(fused=True, extra_input=x),
        "band_rows": dict(band_rows=4, extra_input=x),
        "packed_io": dict(packed_io=True, extra_input=x),
        "shape": dict(extra_input=np.zeros((1, 8, 6, 8), np.float32)),
        "batch": dict(extra_input=np.zeros((2, 8, 8, 8), np.float32)),
    }


@pytest.mark.parametrize("kind", ["fused", "band_rows", "packed_io", "shape",
                                  "batch"])
def test_extra_input_argument_checks_match_reference(kind):
    x, ks, cases = _guard_cases()
    kw = cases[kind]
    with pytest.raises(ValueError) as ref:
        jcp.hex_conv_stack_pallas(x, ks, None, radius=2, data_format="NHWC",
                                  **kw)
    kw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with pytest.raises(ValueError) as got:
        tcs.hex_conv_stack(_t(x), [_t(k) for k in ks], radius=2,
                           data_format="NHWC", **kw)
    assert str(got.value) == str(ref.value)


def test_split_layer_is_forward_only():
    """The split layer with an affine norm (the per-module route's eval
    BN), once forward only (hence the name), trains: its kernel grad is
    autograd's of the plain version on the concatenation
    (test_torch_affine_backward.py holds it to jax.grad); under no_grad
    it runs; an unknown device raises."""
    xa, xb, ks, _, _ = _split_inputs(4, 1, 4, 4, 8, 8, 8, 1, None)
    norm = ("affine", torch.ones(8), torch.zeros(8))
    grads = []
    for fn in (tcs.hex_conv_layer_split, tcs.hex_conv_layer_split_plain):
        k = _t(ks[0]).requires_grad_()
        fn(_t(xa), _t(xb), k, radius=2, norm=norm, relu=True).sum().backward()
        grads.append(k.grad)
    assert torch.equal(*grads)
    with torch.no_grad():
        out = tcs.hex_conv_layer_split(_t(xa), _t(xb),
                                       _t(ks[0]).requires_grad_(), radius=2,
                                       norm=norm)
    assert out.shape == (1, 4, 4, 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        tcs.hex_conv_layer_split(_t(xa).to("meta"), _t(xb).to("meta"),
                                 _t(ks[0]).to("meta"), radius=2)


def test_split_layer_grads_match_plain_autograd():
    """Under grad the stack's split layer gives grads to both inputs, the
    kernel and the GN parameters, equal (1e-4 relative) to torch autograd
    through its plain version; under no_grad it runs."""
    xa, xb, ks, _, ns = _split_inputs(4, 1, 4, 4, 8, 8, 8, 1, "gn")
    grads = []
    for plain in (False, True):
        tk, _, tn = _torch_args(ks, None, ns)
        a, b, k = _t(xa).requires_grad_(), _t(xb).requires_grad_(), tk[0]
        k.requires_grad_()
        tn[0][2].requires_grad_()
        out = tcs.hex_conv_stack(a, [k], radius=2, norms=tn,
                                 data_format="NHWC", extra_input=b,
                                 plain=plain)
        (out * out.detach()).sum().backward()
        grads.append([a.grad, b.grad, k.grad, tn[0][2].grad])
    for got, want in zip(*grads):
        assert got is not None and _rel_err(got, want) <= REL
    tk, _, tn = _torch_args(ks, None, ns)
    with torch.no_grad():
        out = tcs.hex_conv_stack(_t(xa), [tk[0].requires_grad_()], radius=2,
                                 norms=tn, data_format="NHWC",
                                 extra_input=_t(xb))
    assert out.shape == (1, 4, 4, 8)


# ---- HexConvStack(extra=) ---------------------------------------------------

@pytest.mark.parametrize("norm,data_format", [("GN", "NHWC"), (None, "NCHW")])
def test_hexconvstack_extra_matches_flax(norm, data_format):
    """The skip-join stage (8+8 -> 8, depth 2) on converted parameters;
    flax runs its per-op chain on the concatenation (its split kernel is
    held to the port above and in the HexUNet case below)."""
    rng = np.random.default_rng(6)
    shape = (2, 8, 9, 8) if data_format == "NHWC" else (2, 8, 8, 9)
    x, skip = (rng.random(shape).astype(np.float32) for _ in range(2))
    jmod = JHexConvStack(in_channels=16, width=8, depth=2, norm=norm,
                         min_cells=10 ** 9, data_format=data_format)
    variables = random_flax_variables(jmod, x, 2, extra=skip)
    want = jax.jit(lambda v, a, b: jmod.apply(v, a, extra=b))(variables, x,
                                                              skip)
    port = HexConvStack(16, 8, 2, norm=norm, data_format=data_format,
                        device="cpu")
    port.load_state_dict({k: _t(v) for k, v in
                          variables["params"].items()})
    with torch.no_grad():
        got = port(_t(x), extra=_t(skip))
    assert _rel_err(got, want) <= REL


def test_hexconvstack_extra_checks_the_channel_total():
    port = HexConvStack(16, 8, 1, data_format="NHWC", device="cpu")
    with pytest.raises(ValueError, match="in_channels=16"):
        port(torch.zeros((1, 4, 4, 8)), extra=torch.zeros((1, 4, 4, 4)))
    jmod = JHexConvStack(in_channels=16, width=8, depth=1,
                         data_format="NHWC")
    with pytest.raises(ValueError, match="in_channels=16"):
        jmod.init(jax.random.key(0), np.zeros((1, 4, 4, 8), np.float32),
                  extra=np.zeros((1, 4, 4, 4), np.float32))


def test_hexconvstack_extra_casts_both_inputs_and_runs_offset_one():
    """bf16 compute dtype casts x and the skip alike; an input offset of 1
    runs the per-op chain on the concatenation, as the reference does."""
    rng = np.random.default_rng(7)
    x, skip = (_t(rng.random((1, 6, 5, 4))) for _ in range(2))
    port = HexConvStack(8, 4, 1, data_format="NHWC", dtype=torch.bfloat16,
                        device="cpu")
    with torch.no_grad():
        out = port(x, extra=skip.double())
    assert out.dtype == torch.bfloat16
    odd = HexConvStack(8, 4, 1, even_odd_offset=1, data_format="NHWC",
                       device="cpu")
    odd.load_state_dict(port.state_dict())
    jmod = JHexConvStack(in_channels=8, width=4, depth=1, even_odd_offset=1,
                         data_format="NHWC")
    params = {k: v.numpy() for k, v in odd.state_dict().items()}
    want = jmod.apply({"params": params}, x.numpy(), extra=skip.numpy())
    with torch.no_grad():
        got = odd(x, extra=skip)
    assert _rel_err(got, want) <= REL


# ---- HexUNet ----------------------------------------------------------------

# (id, constructor kwargs shared by both packages, rect input size)
CONFIGS = [
    ("GN-transpose", dict(widths=(8, 16), norm="GN"), 32),
    ("GN-pixelshuffle", dict(widths=(8, 16), norm="GN",
                             upsample="pixelshuffle"), 32),
    ("None-transpose-3", dict(widths=(8, 16, 32), norm=None), 32),
    ("GN-depth2", dict(widths=(8, 16), norm="GN", depth=2), 24),
    ("BN-transpose", dict(widths=(8, 16), norm="BN"), 32),
    ("BN-pixelshuffle", dict(widths=(8, 16), norm="BN",
                             upsample="pixelshuffle"), 32),
    ("LN-transpose", dict(widths=(8, 16), norm="LN"), 24),
]


def _unet_case(kw, size, seed, min_cells=10 ** 9):
    rect = np.random.default_rng(seed).random(
        (2, 3, size, size)).astype(np.float32)
    hexed = np.asarray(jm.hexify_batch(rect))
    model = jm.HexUNet(num_classes=3, stack_min_cells=min_cells, **kw)
    variables = random_flax_variables(model, hexed, seed)
    return rect, hexed, model, variables


def _port_logits(kw, variables, rect):
    port = tm.HexUNet(num_classes=3, device="cpu", **kw).eval()
    port.load_state_dict(hexunet_state_dict_from_flax(variables))
    with torch.no_grad():
        return port(tm.hexify_batch(_t(rect)))


@pytest.mark.parametrize("name,kw,size", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_hexunet_logits_match_jax(name, kw, size):
    rect, hexed, model, variables = _unet_case(kw, size, len(name))
    want = jax.jit(model.apply)(variables, hexed)
    got = _port_logits(kw, variables, rect)
    assert got.shape == (2, 3, size // 2, size // 2)
    assert _rel_err(got, want) <= REL


def test_hexunet_matches_jax_on_the_interpreted_split_kernel(monkeypatch):
    """stack_min_cells=0 with the packed encoder off: hygrid_tpu's
    stage-wise route runs its Pallas stack kernel for the encoder and the
    split kernel (#10 split=True) for the decoder, in interpret mode."""
    kw = dict(widths=(8, 16), norm="GN")
    rect, hexed, model, variables = _unet_case(kw, 32, 11, min_cells=0)
    monkeypatch.setattr(jhexunet.HexUNet, "_packed_chain_ok",
                        lambda self, *a: False)
    want = model.apply(variables, hexed)
    got = _port_logits(kw, variables, rect)
    assert _rel_err(got, want) <= REL


def test_converter_maps_every_leaf():
    for kw in (dict(widths=(8, 16), norm="GN"),
               dict(widths=(8, 16), norm="BN", upsample="pixelshuffle")):
        _, hexed, model, variables = _unet_case(kw, 16, 1)
        sd = hexunet_state_dict_from_flax(variables)
        port = tm.HexUNet(num_classes=3, device="cpu", **kw)
        assert sorted(sd) == sorted(port.state_dict())
        port.load_state_dict(sd)   # strict: no missing or unexpected keys
        params = variables["params"]
        np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                      params["head"]["kernel"].T)
        if "Dense_0" in params["up0"]:
            np.testing.assert_array_equal(
                sd["up0.expand.weight"].numpy(),
                params["up0"]["Dense_0"]["kernel"].T)
        else:
            np.testing.assert_array_equal(sd["up0.kernel"].numpy(),
                                          params["up0"]["kernel"])


def test_hexunet_init_from_generator_and_parameter_shapes():
    a, b = (tm.HexUNet(num_classes=4, device="cpu",
                       generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert tuple(sa["enc0.kernel_0"].shape) == (32, 3, 7)
    assert tuple(sa["up0.kernel"].shape) == (64, 128, 7)
    assert tuple(sa["dec0.kernel_0"].shape) == (64, 128, 7)
    assert tuple(sa["dec1.kernel_0"].shape) == (32, 64, 7)
    assert tuple(sa["head.weight"].shape) == (4, 32)
    with pytest.raises(ValueError, match="upsample"):
        tm.HexUNet(num_classes=4, upsample="nearest", device="cpu")


def test_hexunet_small_shapes_and_bf16():
    """HexUNet-small's stages at a small input: bf16 logits track the f32
    model (same weights) within 5e-2, and the stacked decoder trains: the
    f32 model's grads (the split layers' included) equal, 1e-4 relative
    per leaf, those of its plain path."""
    gen = torch.Generator().manual_seed(0)
    model = tm.HexUNet(num_classes=4, dtype=torch.bfloat16, device="cpu",
                       generator=gen)
    ref = tm.HexUNet(num_classes=4, device="cpu")
    ref.load_state_dict(model.state_dict())
    rect = torch.rand((2, 3, 32, 32), generator=gen)
    with torch.no_grad():
        out = model(tm.hexify_batch(rect.to(torch.bfloat16)))
        want = ref(tm.hexify_batch(rect), plain=True)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 16, 16)
    assert float((out.float() - want).abs().max() / want.abs().max()) <= 5e-2
    grads = []
    for plain in (False, True):
        ref.zero_grad(set_to_none=True)
        logits = ref(tm.hexify_batch(rect), plain=plain)
        (logits * want).sum().backward()
        grads.append({n: p.grad for n, p in ref.named_parameters()})
    assert all(g is not None for g in grads[0].values())
    for name, g in grads[0].items():
        assert _rel_err(g, grads[1][name]) <= REL, name
