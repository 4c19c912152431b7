"""The port's hex conv / pool ops against hygrid_tpu.nn.functional and the
reference goldens.  Float32 throughout; convs agree within 1e-5 (only
PyTorch's and XLA's conv summation orders differ)."""
import functools
import os

import numpy as np
import pytest
import torch

from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch.kernels import conv_stack
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.nn import functional as TF
from tools.make_nn_goldens import CONV_CONFIGS, POOL_CONFIGS

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "nn_goldens.npz")
TOL_CONV = 1e-5


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (H, W, radius, stride, padding, dilation, groups, offset): odd and even
# widths, both input parities, the 'same' paddings of the stack
CONV_CASES = [
    (11, 13, 2, 1, 1, 1, 1, 0), (12, 14, 2, 1, 1, 1, 1, 1),
    (11, 14, 2, 1, 0, 1, 1, 1), (12, 13, 3, 1, 2, 1, 1, 0),
    (13, 12, 3, 1, 2, 1, 1, 1), (14, 15, 2, 1, 2, 2, 1, 0),
    (15, 16, 2, 2, 1, 1, 1, 1), (16, 11, 1, 1, 0, 1, 1, 0),
    (12, 12, 2, 1, 1, 1, 2, 0), (17, 9, 3, 2, 3, 2, 1, 1),
]


@functools.lru_cache(maxsize=None)
def _jax_conv_case(n):
    """Inputs of CONV_CASES[n] and hygrid_tpu's direct-conv output."""
    h, w, r, s, p, d, grp, off = CONV_CASES[n]
    rng = np.random.default_rng(n)
    x = rng.random((2, 4, h, w)).astype(np.float32)
    k = rng.normal(0, 0.5, (6, 4 // grp, TF.hex_kernel_num(r))).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    kw = dict(even_odd_offset=off, radius=r, stride=s, padding=p, dilation=d,
              groups=grp)
    return x, k, b, kw, np.asarray(JF.hex_conv2d(x, k, b, impl="direct", **kw))


@pytest.mark.parametrize("impl", ["direct", "type1"])
@pytest.mark.parametrize("n", range(len(CONV_CASES)))
def test_hex_conv2d_matches_jax(n, impl):
    h, w, r, s, p, d, grp, off = CONV_CASES[n]
    x, k, b, kw, want = _jax_conv_case(n)
    got = TF.hex_conv2d(_t(x), _t(k), _t(b), impl=impl, **kw)
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[-2:]) == TF.hex_conv2d_output_shape(h, w, r, s, p, d)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_CONV, rtol=0)


def _tap_table_conv(x_nhwc, kernel, table):
    """Emulates the CUDA conv pass: output (o, j) with parity q = o % 2
    sums kernel[:, :, t] @ x[o + T[q,t,0], j + T[q,t,1]] (zero outside)."""
    b, h, w, c = x_nhwc.shape
    out = np.zeros((b, h, w, kernel.shape[0]), np.float64)
    for q in (0, 1):
        for t in range(table.shape[1]):
            dr, dc = table[q, t]
            for o in range(q, h, 2):
                i = o + dr
                if not 0 <= i < h:
                    continue
                j0, j1 = max(0, -dc), min(w, w - dc)
                out[:, o, j0:j1] += x_nhwc[:, i, j0 + dc:j1 + dc] @ kernel[:, :, t].T
    return out


@pytest.mark.parametrize("radius,dilation", [(1, 1), (2, 1), (3, 1), (2, 2),
                                             (3, 2), (4, 1)])
@pytest.mark.parametrize("hw", [(10, 9), (9, 12)])
def test_tap_table_matches_direct_conv(radius, dilation, hw):
    """The kernel's (2, kn, 2) tap table reproduces hex_conv2d(direct) with
    'same' padding d*(r-1), on odd and even heights and widths."""
    h, w = hw
    table = TF.hex_tap_table(radius, dilation)
    kn = TF.hex_kernel_num(radius)
    assert table.shape == (2, kn, 2) and table.dtype == np.int32
    rng = np.random.default_rng(radius * 10 + dilation)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    k = rng.normal(0, 0.5, (5, 3, kn)).astype(np.float32)
    want = np.asarray(JF.hex_conv2d(np.moveaxis(x, -1, 1), k, radius=radius,
                                    padding=dilation * (radius - 1),
                                    dilation=dilation, impl="direct"))
    got = _tap_table_conv(x, k, table)
    np.testing.assert_allclose(np.moveaxis(got, -1, 1), want, atol=TOL_CONV)


def test_hex_conv_layer_cpu_runs_plain_version():
    rng = np.random.default_rng(5)
    x = _t(rng.random((2, 9, 11, 4)).astype(np.float32))
    k = _t(rng.normal(size=(8, 4, 7)).astype(np.float32))
    norm = ("gn", 4, torch.ones(8), torch.zeros(8))
    before = counts().get("hex_conv_layer", 0)
    got = conv_stack.hex_conv_layer(x, k, radius=2, norm=norm, relu=True)
    want = conv_stack.hex_conv_layer_plain(x, k, radius=2, norm=norm, relu=True)
    assert torch.equal(got, want) and counts().get("hex_conv_layer", 0) == before


@pytest.mark.parametrize("impl", ["type1", "direct"])
@pytest.mark.parametrize("n", range(len(CONV_CONFIGS)))
def test_hex_conv2d_golden(g, n, impl):
    r, s, p, d, grp, off, bias = CONV_CONFIGS[n]
    k = g[f"conv{n}_kernel"][:, :, 0, :]
    b = g[f"conv{n}_bias"] if bias else None
    out = TF.hex_conv2d(_t(g["conv_x"]), _t(k), None if b is None else _t(b),
                        even_odd_offset=off, radius=r, stride=s, padding=p,
                        dilation=d, groups=grp, impl=impl)
    want = g[f"conv{n}_out"]
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("n", range(len(POOL_CONFIGS)))
def test_hex_pool2d_golden(g, n):
    meth, k, s, p, off, ceil, cip = POOL_CONFIGS[n]
    out = TF.hex_pool2d(_t(g["pool_x"]), meth, kernel_size=k, stride=s,
                        padding=p, even_odd_offset=off, ceil_mode=ceil,
                        count_include_pad=cip)
    want = g[f"pool{n}_out"]
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)


POOL_CASES = [("max", 2, 2, 0, False, True), ("min", 3, 2, 0, False, True),
              ("average", 2, 2, 0, False, True), ("max", 3, 2, 1, True, True),
              ("average", 3, 3, 0, True, False),
              ("average", (1, 2), (2, 3), 0, False, True),
              ("max", (3, 2), (1, 2), 2, True, False)]


def _pool_input():
    x = np.random.default_rng(7).random((2, 3, 21, 18)).astype(np.float32)
    x[0, 1, ::5, ::3] = np.nan
    return x


@pytest.mark.parametrize("case", POOL_CASES)
def test_hex_pool2d_matches_jax(case):
    meth, k, s, p, ceil, cip = case
    x = _pool_input()
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              count_include_pad=cip)
    want = np.asarray(JF.hex_pool2d(x, meth, **kw))
    got = TF.hex_pool2d(_t(x), meth, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("case", POOL_CASES)
def test_hex_pool2d_nhwc_equals_nchw(case):
    """NHWC pooling (the model's layout) is NCHW pooling under a transpose
    (max/min exactly; 'average' sums in a layout-dependent order, 1 ulp)."""
    meth, k, s, p, ceil, cip = case
    x = _t(_pool_input())
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              count_include_pad=cip)
    want = TF.hex_pool2d(x, meth, **kw)
    got = TF.hex_pool2d(x.permute(0, 2, 3, 1).contiguous(), meth,
                        data_format="NHWC", **kw)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want.numpy(),
                               rtol=0, atol=0 if meth != "average" else 1e-6,
                               equal_nan=True)


def test_hex_pool2d_model_shapes():
    """The HexCNN pool: (B, 256, 256, C) -> 128x127 -> 64x63, NHWC."""
    x = torch.rand((1, 256, 256, 2))
    y = TF.hex_pool2d(x, "max", 2, 2, data_format="NHWC")
    assert tuple(y.shape) == (1, 128, 127, 2)
    assert tuple(TF.hex_pool2d(y, "max", 2, 2, data_format="NHWC").shape) == \
        (1, 64, 63, 2)


@pytest.mark.parametrize("method", ["max", "min", "average"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_hex_global_pool2d_matches_jax(method, data_format):
    x = np.random.default_rng(8).random((3, 4, 9, 7)).astype(np.float32)
    x[0, :, ::2] = np.nan
    x[1, 2] = np.nan                      # an all-NaN channel -> NaN average
    if data_format == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    want = np.asarray(JF.hex_global_pool2d(x, method, data_format=data_format))
    got = TF.hex_global_pool2d(_t(x), method, data_format=data_format)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("name", ["max_pooling", "min_pooling",
                                  "average_pooling"])
def test_nan_aware_reductions(name):
    x = np.random.default_rng(9).random((4, 6)).astype(np.float32)
    x[0, 1] = np.nan
    x[2] = np.nan
    want = np.asarray(getattr(JF, name)(x, axis=-1))
    got = getattr(TF, name)(_t(x), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("mode", ["constant", "zeros", "reflect", "replicate",
                                  "circular"])
def test_pad2d_matches_jax(mode):
    x = np.random.default_rng(10).random((2, 3, 6, 5)).astype(np.float32)
    for padding in (2, (1, 2, 0, 3)):
        want = np.asarray(JF.pad2d(x, padding, mode, 0.5))
        got = TF.pad2d(_t(x), padding, mode, 0.5)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius,dilation", [(1, 1), (2, 1), (3, 2)])
def test_scatter_hex_kernel_matches_jax(radius, dilation):
    k = np.random.default_rng(11).random(
        (3, 2, TF.hex_kernel_num(radius))).astype(np.float32)
    want = np.asarray(JF.scatter_hex_kernel(k, radius, dilation))
    np.testing.assert_array_equal(
        TF.scatter_hex_kernel(_t(k), radius, dilation).numpy(), want)


def test_unported_impls_and_methods_raise():
    """``auto``, ``mxu`` and ``packed`` (XLA formulations in hygrid_tpu) run
    ``direct``; an unknown impl and the undefined centroid pooling raise."""
    x = torch.rand((1, 2, 6, 6), generator=torch.Generator().manual_seed(0))
    k = torch.rand((3, 2, 7), generator=torch.Generator().manual_seed(1))
    want = TF.hex_conv2d(x, k, radius=2, padding=1, impl="direct")
    for impl in ("auto", "mxu", "packed"):
        assert torch.equal(TF.hex_conv2d(x, k, radius=2, padding=1,
                                         impl=impl), want)
    with pytest.raises(ValueError, match="unknown impl"):
        TF.hex_conv2d(x, k, radius=2, impl="nope")
    with pytest.raises(NotImplementedError, match="centroid"):
        TF.hex_pool2d(x, "centroid")
    with pytest.raises(ValueError, match="exceeds input"):
        TF.hex_pool2d(torch.zeros((1, 1, 2, 2)), "max", 3, 1)
