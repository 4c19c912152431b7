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


@pytest.mark.parametrize("option", [dict(fused=True), dict(band_rows=8),
                                    dict(packed_io=True),
                                    dict(extra_input=torch.zeros(1, 4, 4, 8))])
def test_unported_stack_options_raise(option):
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
