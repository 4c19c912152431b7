"""hex_conv_stack (kernel B's stack API, run here through the layers' plain
versions) against hygrid_tpu's stack: the Pallas stack kernel in interpret
mode at a tiny size, and its XLA twin ``_stack_xla`` at a larger one.

Float32; relative max-abs error <= 1e-4: GroupNorm divides by the group's
standard deviation, which rescales the conv's summation-order differences.
"""
import jax
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu.nn.layers import HexConvStack as JHexConvStack
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.nn import HexConvStack
from hygrid_tpu_torch.nn.functional import hex_kernel_num

REL = 1e-4


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _stack_inputs(seed, b, h, w, c, depth, radius, norm_kind, cin=None):
    rng = np.random.default_rng(seed)
    kn = hex_kernel_num(radius)
    cin = c if cin is None else cin
    x = rng.random((b, h, w, cin)).astype(np.float32)
    kernels = [rng.normal(0, 1 / np.sqrt(kn * (cin if i == 0 else c)),
                          (c, cin if i == 0 else c, kn)).astype(np.float32)
               for i in range(depth)]
    biases = None
    norms = None
    if norm_kind is None:
        biases = [rng.normal(0, 0.1, c).astype(np.float32) for _ in kernels]
    elif norm_kind == "gn":
        norms = [("gn", 4, 1 + 0.2 * rng.random(c).astype(np.float32),
                  rng.normal(0, 0.2, c).astype(np.float32)) for _ in kernels]
    else:
        norms = [("affine", 1 + 0.2 * rng.random(c).astype(np.float32),
                  rng.normal(0, 0.2, c).astype(np.float32)) for _ in kernels]
    return x, kernels, biases, norms


def _to_torch(kernels, biases, norms):
    t = torch.from_numpy
    tk = [t(k) for k in kernels]
    tb = None if biases is None else [t(b) for b in biases]
    tn = None
    if norms is not None:
        tn = [(n[0],) + tuple(t(a) if isinstance(a, np.ndarray) else a
                              for a in n[1:]) for n in norms]
    return tk, tb, tn


def _port(x, kernels, biases, norms, **kw):
    tk, tb, tn = _to_torch(kernels, biases, norms)
    return tcs.hex_conv_stack(torch.from_numpy(x), tk, tb, norms=tn,
                              data_format="NHWC", **kw).numpy()


NORMS = [None, "gn", "affine"]


@pytest.mark.parametrize("activation", ["relu", None])
@pytest.mark.parametrize("norm_kind", NORMS)
def test_stack_matches_pallas_kernel_interpret(norm_kind, activation):
    """b=2, 8x8, C=8, 2 layers through hex_conv_stack_pallas, which runs
    the Pallas stack kernel in interpret mode on the CPU."""
    x, kernels, biases, norms = _stack_inputs(0, 2, 8, 8, 8, 2, 2, norm_kind)
    want = np.asarray(jcp.hex_conv_stack_pallas(
        x, kernels, biases, radius=2, activation=activation, norms=norms,
        data_format="NHWC"))
    got = _port(x, kernels, biases, norms, radius=2, activation=activation)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("final_activation", [True, False])
@pytest.mark.parametrize("norm_kind", NORMS)
def test_stack_matches_stack_xla(norm_kind, final_activation):
    """b=2, 24x19 (odd width), C=16, 3 layers against the XLA twin."""
    x, kernels, biases, norms = _stack_inputs(1, 2, 24, 19, 16, 3, 2,
                                              norm_kind)
    kinds, arrays = jcp._split_norms(norms, kernels)
    statics = (2, 1, "relu", final_activation, False, None, kinds, None,
               "NHWC", None, False)
    want = np.asarray(jcp._stack_xla(
        x, kernels, (None,) * 3 if biases is None else tuple(biases), arrays,
        statics))
    got = _port(x, kernels, biases, norms, radius=2,
                final_activation=final_activation)
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("radius,dilation", [(3, 1), (2, 2)])
def test_stack_other_radius_and_dilation(radius, dilation):
    x, kernels, _, norms = _stack_inputs(2, 1, 14, 13, 8, 2, radius, "gn")
    kinds, arrays = jcp._split_norms(norms, kernels)
    statics = (radius, dilation, "relu", True, False, None, kinds, None,
               "NHWC", None, False)
    want = np.asarray(jcp._stack_xla(x, kernels, (None, None), arrays,
                                     statics))
    got = _port(x, kernels, None, norms, radius=radius, dilation=dilation)
    assert _rel_err(got, want) <= REL


def test_stack_nchw_equals_nhwc():
    x, kernels, _, norms = _stack_inputs(3, 2, 10, 9, 8, 2, 2, "gn")
    tk, _, tn = _to_torch(kernels, None, norms)
    nhwc = tcs.hex_conv_stack(torch.from_numpy(x), tk, norms=tn, radius=2,
                              data_format="NHWC")
    nchw = tcs.hex_conv_stack(torch.from_numpy(x).permute(0, 3, 1, 2), tk,
                              norms=tn, radius=2, data_format="NCHW")
    assert torch.equal(nchw.permute(0, 2, 3, 1), nhwc)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(1.0, 2.0, (2, 16, 7, 9)).astype(np.float32)
    gamma = rng.random(16).astype(np.float32)
    beta = rng.normal(size=16).astype(np.float32)
    want = np.asarray(jcp._group_norm_nchw(v, 4, gamma, beta))
    got = tcs._group_norm_nchw(torch.from_numpy(v), 4, torch.from_numpy(gamma),
                               torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("min_cells", [0, 1024])
def test_hexconvstack_module_matches_jax(min_cells):
    """HexConvStack (3 -> 16, GN) with weights carried over by name; JAX
    runs the Pallas stack kernel (min_cells=0) or its per-op chain."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 12, 11, 3)).astype(np.float32)
    jm = JHexConvStack(in_channels=3, width=16, depth=2, norm="GN",
                       min_cells=min_cells, data_format="NHWC")
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(0), x)["params"])
    params = {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
              for k, v in params.items()}
    want = np.asarray(jm.apply({"params": params}, x))
    tm = HexConvStack(3, 16, 2, norm="GN", data_format="NHWC", device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel_err(got, want) <= REL


def test_hexconvstack_parameters_and_generator():
    a = HexConvStack(3, 8, 2, norm=None, device="cpu",
                     generator=torch.Generator().manual_seed(7))
    b = HexConvStack(3, 8, 2, norm=None, device="cpu",
                     generator=torch.Generator().manual_seed(7))
    names = [n for n, _ in a.named_parameters()]
    assert names == ["kernel_0", "bias_0", "kernel_1", "bias_1"]
    assert tuple(a.kernel_0.shape) == (8, 3, 7)
    bound = 1 / np.sqrt(3 * 7)
    assert float(a.kernel_0.detach().abs().max()) <= bound
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)
    gn = HexConvStack(4, 8, 1, norm="GN", device="cpu")
    assert [n for n, _ in gn.named_parameters()] == \
        ["kernel_0", "gn_scale_0", "gn_bias_0"]


@pytest.mark.parametrize("option", [dict(packed_io=True)])
def test_unported_stack_options_raise(option):
    """packed_io (the TPU's packed planes) stays unported; extra_input now
    runs the split layer (tests/test_torch_hexunet.py)."""
    k = torch.zeros((8, 8, 7))
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.hex_conv_stack(torch.zeros((1, 4, 4, 8)), [k], radius=2,
                           data_format="NHWC", **option)


def test_stack_argument_checks():
    x, k = torch.zeros((1, 4, 4, 8)), torch.zeros((8, 8, 7))
    with pytest.raises(ValueError, match="offset-0"):
        tcs.hex_conv_stack(x, [k], radius=2, even_odd_offset=1)
    with pytest.raises(ValueError, match="groups do not divide"):
        tcs.hex_conv_stack(x, [k], radius=2, data_format="NHWC",
                           norms=[("gn", 3, torch.ones(8), torch.zeros(8))])
    with pytest.raises(ValueError, match="no kernel for device"):
        tcs.hex_conv_layer(x.to("meta"), k.to("meta"), radius=2)


# ---- fused=True and band_rows against the reference's own kernels ---------

FUSED_CASES = [(16, 2, 3, 16, 16, True), (16, 2, 4, 18, 13, False),
               (32, 3, 2, 12, 10, True)]   # tests/test_kernels.py:194-199


def _fused_inputs(C, r, L, h, w, bias_on):
    """The reference test's draws (NCHW input, uniform weights)."""
    rng = np.random.default_rng(C + L)
    x = rng.random((2, C, h, w)).astype(np.float32)
    ks = [(rng.random((C, C, hex_kernel_num(r))) - 0.5).astype(np.float32)
          for _ in range(L)]
    bs = ([rng.random(C).astype(np.float32) for _ in range(L)]
          if bias_on else None)
    return x, ks, bs


@pytest.mark.parametrize("final_activation", [True, False])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_stack_matches_pallas_fused(case, final_activation):
    """fused=True against hex_conv_stack_pallas(fused=True), whose
    _fused_stack_kernel runs in interpret mode; float32, 1e-5 relative."""
    C, r, L, h, w, bias_on = case
    x, ks, bs = _fused_inputs(*case)
    want = np.asarray(jcp.hex_conv_stack_pallas(
        x, ks, bs, radius=r, fused=True, final_activation=final_activation))
    tk, tb, _ = _to_torch(ks, bs, None)
    got = tcs.hex_conv_stack(torch.from_numpy(x), tk, tb, radius=r,
                             fused=True, final_activation=final_activation)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= 1e-5


def test_fused_stack_grads_match_jax():
    """Grads of sum(out * g) through fused=True against jax.grad through
    the reference's fused stack (its VJP recomputes through _stack_xla),
    at the first reference case (with biases); 1e-4 relative per leaf."""
    r = FUSED_CASES[0][1]
    x, ks, bs = _fused_inputs(*FUSED_CASES[0])
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def loss(x, ks, bs):
        return jax.numpy.sum(jcp.hex_conv_stack_pallas(
            x, ks, bs, radius=r, fused=True) * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, ks, bs)
    tx = torch.from_numpy(x).requires_grad_()
    tk = [torch.from_numpy(k).requires_grad_() for k in ks]
    tb = [torch.from_numpy(b).requires_grad_() for b in bs]
    out = tcs.hex_conv_stack(tx, tk, tb, radius=r, fused=True)
    (out * torch.from_numpy(g)).sum().backward()
    got = [tx.grad] + [k.grad for k in tk] + [b.grad for b in tb]
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(flat_want)
    for a, b in zip(got, flat_want):
        assert _rel_err(a.numpy(), np.asarray(b)) <= 1e-4


@pytest.mark.parametrize("C,r,L,h,w,bg,brr,bias_on", [
    (16, 2, 3, 16, 16, 2, 4, True),
    (32, 3, 2, 12, 10, 1, 4, True),
    (128, 2, 2, 12, 10, 1, 4, True),
])   # tests/test_kernels.py:640-645 but the non-dividing band case
def test_banded_stack_matches_pallas_banded(C, r, L, h, w, bg, brr, bias_on):
    """band_rows against hex_conv_stack_pallas(band_rows=...), whose
    _stack_layer_kernel_banded runs in interpret mode; 1e-5 relative."""
    rng = np.random.default_rng(C * 7 + L)
    x = rng.random((6, C, h, w)).astype(np.float32)
    ks = [(rng.random((C, C, hex_kernel_num(r))) - 0.5).astype(np.float32)
          for _ in range(L)]
    bs = ([rng.random(C).astype(np.float32) for _ in range(L)]
          if bias_on else None)
    want = np.asarray(jcp.hex_conv_stack_pallas(
        x, ks, bs, radius=r, batch_group=bg, band_rows=brr))
    tk, tb, _ = _to_torch(ks, bs, None)
    got = tcs.hex_conv_stack(torch.from_numpy(x), tk, tb, radius=r,
                             band_rows=brr)
    assert _rel_err(got.numpy(), want) <= 1e-5


def _guard_args(kind):
    c = 16
    x = np.zeros((1, c, 8, 8), np.float32)
    ks = [np.zeros((c, c, 7), np.float32)] * 2
    gn = [("gn", 4, np.ones(c, np.float32), np.zeros(c, np.float32))] * 2
    return x, ks, {
        "fused+norms": dict(radius=2, fused=True, norms=gn),
        "band+norms": dict(radius=2, band_rows=4, norms=gn),
        "band+fused": dict(radius=2, band_rows=4, fused=True),
        "band+margin": dict(radius=4, band_rows=4),
    }[kind]


@pytest.mark.parametrize("kind", ["fused+norms", "band+norms", "band+fused",
                                  "band+margin"])
def test_fused_and_band_guards_match_reference(kind):
    x, ks, kw = _guard_args(kind)
    if kw["radius"] == 4:
        ks = [np.zeros((16, 16, hex_kernel_num(4)), np.float32)] * 2
    with pytest.raises(ValueError) as ref:
        jcp.hex_conv_stack_pallas(x, ks, None, **kw)
    tn = None
    if "norms" in kw:
        kw = dict(kw)
        tn = _to_torch(ks, None, kw.pop("norms"))[2]
    tk = [torch.from_numpy(k) for k in ks]
    with pytest.raises(ValueError) as got:
        tcs.hex_conv_stack(torch.from_numpy(x), tk, norms=tn, **kw)
    assert str(got.value) == str(ref.value)


def test_band_margin_rule_matches_reference():
    for r in range(1, 6):
        for d in range(1, 4):
            for q in (1, 2, 4, 8, 16, 32, 64, 128):
                assert tcs._same_margin_feasible(r, d, q) == \
                    jcp._same_meta_feasible(r, d, q), (r, d, q)


def test_fused_stack_wrapper_refuses_other_devices_and_mixed_widths():
    k = torch.zeros((8, 8, 7))
    with pytest.raises(ValueError, match="no kernel for device"):
        tcs.hex_conv_fused_stack(torch.zeros((1, 4, 4, 8), device="meta"),
                                 [k.to("meta")] * 2, radius=2,
                                 relus=[True, True])
    with pytest.raises(ValueError, match="relus"):
        tcs.hex_conv_fused_stack(torch.zeros((1, 4, 4, 8)), [k] * 2,
                                 radius=2, relus=[True])
    # a stack whose widths differ chains its layers under fused=True, as
    # conv_pallas.py:1544 does
    x = torch.rand((1, 6, 5, 3))
    ks = [torch.rand((8, 3, 7)), torch.rand((8, 8, 7))]
    before = counts().get("hex_conv_fused_stack", 0)
    assert torch.equal(
        tcs.hex_conv_stack(x, ks, radius=2, data_format="NHWC", fused=True),
        tcs.hex_conv_stack(x, ks, radius=2, data_format="NHWC"))
    assert counts().get("hex_conv_fused_stack", 0) == before
