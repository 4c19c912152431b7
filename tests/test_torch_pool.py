"""The hex max-pool op (``kernels/pool.py``: ``hygrid::hex_max_pool`` and its
backward) on the CPU, where each op runs its plain version, against
``hex_pool2d``'s plain path (``nn/functional.py::_window_reduce`` and its
autograd); and the routing rule of ``hex_pool2d``, which sends only NHWC
max-pools of CUDA tensors to the kernel.

* Values and input gradients bit for bit (ReLU'd values on a coarse grid,
  which tie in most windows), float32 and bfloat16, odd and even H and W,
  windows 1 x 2, 2 x 1 and 2 x 2, strides 2 and 3; NaN cells, an all-NaN
  window, +-inf, the cells no window covers (gradient 0) and a gradient
  that is not finite;
* where no gradient is wanted the op runs without an autograd node, and
  the backward runs in the span ``hygrid.pool_backward``;
* the backward is differentiable in turn (``create_graph=True``): a
  gradient penalty's second-order gradient equals the plain path's in
  value (a zero's sign may differ) and its first-order one bit for bit;
* the pools the kernel does not take (NCHW, min, average, padding, ceil
  mode, overlapping or 3-wide windows, float64) keep the plain path: no
  launch counted, the plain results.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hygrid_tpu_torch.kernels import pool
from hygrid_tpu_torch.nn import functional as F
from hygrid_tpu_torch.utils.profiling import counts

DTYPES = [torch.float32, torch.bfloat16]
SHAPES = [(2, 9, 10, 3), (1, 8, 11, 5), (2, 7, 7, 4), (1, 12, 12, 8)]
WINDOWS = [(1, 2), (2, 1), (2, 2)]
STRIDES = [2, 3]


def _bits(t):
    """The tensor's bit patterns, NaNs made one pattern (payloads differ
    between the CPU's kernels and torch's conversions)."""
    t = torch.where(torch.isnan(t), torch.nan, t)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _ties(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(shape, generator=gen) * 2) / 2
    return torch.clamp(x, min=0).to(dtype)


def _plain(x, kernel, stride, cot):
    """``hex_pool2d``'s plain path on the CPU and its autograd."""
    t = x.clone().requires_grad_()
    out = F.hex_pool2d(t, "max", kernel_size=kernel, stride=stride,
                       data_format="NHWC", device="cpu")
    out.backward(cot)
    return out.detach(), t.grad


def _op(x, kernel, stride, cot):
    t = x.clone().requires_grad_()
    out = pool.hex_max_pool(t, kernel, (stride, stride))
    out.backward(cot)
    return out.detach(), t.grad


def _cot(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("kernel", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_op_is_bit_equal_to_the_plain_path(dtype, shape, kernel, stride):
    x = _ties(shape, dtype, SHAPES.index(shape))
    hn, wn = pool.pool_shape(shape[1], shape[2], *kernel, stride, stride)
    cot = _cot((shape[0], hn, wn, shape[3]), dtype, 1)
    want, want_grad = _plain(x, kernel, (stride, stride), cot)
    got, grad = _op(x, kernel, stride, cot)
    assert got.shape == (shape[0], hn, wn, shape[3]) and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(grad), _bits(want_grad))


def _edge_input(dtype):
    """(2, 7, 10, 3) with a NaN cell, an all-NaN window, +-inf, a window of
    -inf and NaN, the rest tied ReLU'd values."""
    x = _ties((2, 7, 10, 3), dtype, 5)
    x[0, 0, 0, 0] = float("nan")                 # one NaN cell
    x[0, 2:4, 1:3, 1] = float("nan")             # window (1, 0): all NaN
    x[0, 4, 4, 2] = float("inf")
    x[1, 0, 2, 0] = -float("inf")                # -inf beside a max
    x[1, 2, 3, 2] = -float("inf")                # window (1, 1): -inf and NaN
    x[1, 2:4, 4, 2] = float("nan")
    x[1, 3, 3, 2] = float("nan")
    return x


@pytest.mark.parametrize("kernel", WINDOWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_op_at_nan_inf_and_uncovered_cells(dtype, kernel):
    x = _edge_input(dtype)
    hn, wn = pool.pool_shape(7, 10, *kernel, 2, 2)
    cot = _cot((2, hn, wn, 3), dtype, 2)
    cot[1, 1, 1, 2] = -1e-40                     # underflows when halved
    want, want_grad = _plain(x, kernel, (2, 2), cot)
    got, grad = _op(x, kernel, 2, cot)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(grad), _bits(want_grad))
    # NaN cells and the cells no window covers get 0: the last column of
    # even window rows, the first and last of odd ones, the last row (H odd)
    assert float(grad.float()[0, 0, 0, 0]) == 0.0
    assert not grad[0, 2:4, 1:3, 1].float().any()
    assert not grad[:, 0:2, 8:].float().any()
    assert not grad[:, 2:4, 0].float().any() and not grad[:, 2:4, 9].float().any()
    if kernel[0] == 2:
        assert not grad[:, 6].float().any()
    assert float(got.float()[0, 1, 0, 1]) == -float("inf")


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_where_the_gradient_is_not_finite(dtype):
    x = _ties((1, 6, 9, 2), dtype, 7)
    cot = _cot((1, 3, 4, 2), dtype, 3)
    cot[0, 0, 0, 0] = float("inf")
    cot[0, 1, 1, 1] = float("nan")
    cot[0, 2, 3, 0] = -float("inf")
    want, want_grad = _plain(x, (2, 2), (2, 2), cot)
    got, grad = _op(x, (2, 2), 2, cot)
    assert torch.equal(_bits(grad), _bits(want_grad))


def second_order(pool_fn, x, cot, weight):
    """``(dx, d sum(dx * weight) / d cot)`` of ``pool_fn``, the gradient
    and the second-order gradient a gradient penalty takes (also run on
    the card by the CUDA tests)."""
    t = x.clone().requires_grad_()
    v = cot.clone().requires_grad_()
    dx, = torch.autograd.grad(pool_fn(t), t, v, create_graph=True)
    dv, = torch.autograd.grad((dx * weight).sum(), v)
    return dx.detach(), dv


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("kernel", WINDOWS)
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_is_differentiable_as_the_plain_path(dtype, edges, kernel,
                                                      stride):
    x = _edge_input(dtype) if edges else _ties((2, 9, 10, 3), dtype, 8)
    hn, wn = pool.pool_shape(x.shape[1], x.shape[2], *kernel, stride, stride)
    cot = _cot((x.shape[0], hn, wn, 3), dtype, 4)
    weight = _cot(x.shape, dtype, 5)
    want_dx, want = second_order(
        lambda t: F.hex_pool2d(t, "max", kernel_size=kernel, stride=stride,
                               data_format="NHWC", device="cpu"),
        x, cot, weight)
    got_dx, got = second_order(
        lambda t: pool.hex_max_pool(t, kernel, (stride, stride)), x, cot,
        weight)
    assert torch.equal(_bits(got_dx), _bits(want_dx))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mask", [False, True])
def test_mask_bits_are_the_ties_and_nans(mask):
    x = torch.tensor([[1.0, 1.0], [float("nan"), 1.0]]).reshape(1, 2, 2, 1)
    x = torch.cat([x, torch.full((1, 2, 1, 1), 5.0)], 2)       # (1, 2, 3, 1)
    out, bits = torch.ops.hygrid.hex_max_pool(x, 2, 2, 2, 2, mask)
    assert out.shape == (1, 1, 1, 1) and float(out) == 1.0
    if mask:   # ties (0, 0), (0, 1), (1, 1); (1, 0) NaN
        assert bits.dtype == torch.uint8 and int(bits) == 0b100_1011
    else:
        assert bits.numel() == 0


def test_no_autograd_node_without_a_gradient():
    x = _ties((1, 6, 8, 2), torch.float32, 0)
    assert pool.hex_max_pool(x, (2, 2), (2, 2)).grad_fn is None
    with torch.no_grad():
        t = x.clone().requires_grad_()
        assert pool.hex_max_pool(t, (2, 2), (2, 2)).grad_fn is None
    t = x.clone().requires_grad_()
    assert type(pool.hex_max_pool(t, (2, 2), (2, 2)).grad_fn).__name__ == \
        "_HexMaxPoolBackward"


def test_backward_runs_in_its_span():
    t = _ties((2, 8, 9, 4), torch.float32, 1).requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        pool.hex_max_pool(t, (2, 2), (2, 2)).sum().backward()
    found = [e for e in p.events() if e.name == "hygrid.pool_backward"]
    assert len(found) == 1
    assert found[0].cpu_parent.name == "_HexMaxPoolBackward"
    assert any(c.name == "hygrid::hex_max_pool_backward"
               for c in found[0].cpu_children)


@pytest.mark.parametrize("kernel,stride", [((3, 2), 2), ((2, 2), 1)])
def test_op_refuses_what_the_kernel_does_not_take(kernel, stride):
    with pytest.raises(ValueError, match="at most 2 x 2"):
        pool.hex_max_pool(torch.zeros((1, 8, 8, 2)), kernel, (stride, stride))


# ---- routing ----------------------------------------------------------------

# hex_pool2d calls the kernel does not take: (x's shape, its layout and
# dtype, hex_pool2d's arguments)
PLAIN_ROUTES = {
    "nchw": ((2, 3, 9, 10), "NCHW", torch.float32, dict(method="max")),
    "min": ((2, 9, 10, 3), "NHWC", torch.float32, dict(method="min")),
    "average": ((2, 9, 10, 3), "NHWC", torch.float32,
                dict(method="average")),
    "padding": ((2, 9, 10, 3), "NHWC", torch.float32,
                dict(method="max", padding=1)),
    "ceil_mode": ((2, 9, 10, 3), "NHWC", torch.float32,
                  dict(method="max", ceil_mode=True)),
    "overlapping": ((2, 9, 10, 3), "NHWC", torch.float32,
                    dict(method="max", kernel_size=2, stride=(1, 2))),
    "3-wide": ((2, 9, 10, 3), "NHWC", torch.float32,
               dict(method="max", kernel_size=(2, 3), stride=3)),
    "float64": ((2, 9, 10, 3), "NHWC", torch.float64, dict(method="max")),
}


def plain_route_case(name, device):
    """``(hex_pool2d's result on ``device``, the plain path's)`` of one
    routing case (also run on the card by the CUDA tests)."""
    shape, fmt, dtype, kw = PLAIN_ROUTES[name]
    x = torch.rand(shape, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64).to(dtype)
    x[0, 1, 1, 1] = float("nan")
    got = F.hex_pool2d(x.to(device), data_format=fmt, **kw).cpu()
    nhwc = fmt == "NHWC"
    y = x.permute(0, 3, 1, 2) if nhwc else x
    y = F.pad2d(y, kw.get("padding", 0))
    k = kw.get("kernel_size", 2)
    kh, kw_ = (k, k) if isinstance(k, int) else k
    s = kw.get("stride", k)
    sh, sw = (s, s) if isinstance(s, int) else s
    if kw.get("ceil_mode"):   # the plain path pads; compare with it whole
        want = F.hex_pool2d(x, data_format=fmt, device="cpu", **kw)
        return got, want
    h, w = y.shape[2], y.shape[3]
    hn, wn = (h - kh) // sh + 1, (w - sw // 2) // sw
    want = F._window_reduce(y, kw["method"], hn, wn, kh, kw_, sh, sw,
                            sw // 2, nhwc)
    return got, want


@pytest.mark.parametrize("name", list(PLAIN_ROUTES))
def test_pools_the_kernel_does_not_take_stay_plain(name):
    before = counts().get("hex_max_pool", 0)
    got, want = plain_route_case(name, "cpu")
    assert counts().get("hex_max_pool", 0) == before
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_the_cpu_keeps_the_plain_path_for_the_models_pool():
    """The models' NHWC 2 x 2 max-pool of a CPU tensor runs the plain path:
    no op call, the plain autograd nodes."""
    x = _ties((2, 8, 9, 4), torch.float32, 2).requires_grad_()
    out = F.hex_pool2d(x, "max", kernel_size=2, stride=2,
                       data_format="NHWC")
    assert type(out.grad_fn).__name__ == "AmaxBackward0"

