"""The hex max-pool (``csrc/hex_pool.cu``) on NHWC tensors, and its backward.

It replaces no TPU kernel (``hygrid_tpu``'s pools are XLA): it takes the
place of :func:`hygrid_tpu_torch.nn.functional.hex_pool2d`'s plain window
gather, ``isnan``/``where`` and two ``amax`` passes on the models' stacked
route, windows of at most 2 x 2 cells that do not overlap (``kh <= min(sh,
2)``, ``kw <= min(sw, 2)``), and of their three autograd nodes.

Window ``(gi, gj)`` covers rows ``sh*gi + [0, kh)`` and columns ``(gi %
2)*(sw//2) + sw*gj + [0, kw)``; a NaN counts as -inf; the window reduces
over its rows first, then its columns, as ``_window_reduce`` does.  The
op ``hygrid::hex_max_pool`` returns the pooled ``(B, hn, wn, C)`` tensor
and, where asked, a uint8 tie mask of the same shape: bit ``2i + j`` set
where cell ``(i, j)`` (NaN as -inf) equals the window's maximum, bit ``4 +
2i + j`` where it is NaN.  ``hygrid::hex_max_pool_backward`` turns the
output gradient and the mask into the input gradient: 0 at a cell no window
covers and at a NaN cell, else the gradient split as autograd of the two
``amax`` stages splits it (evenly among the tied columns, then evenly among
a column's tied cells: three tied cells of a 2 x 2 window get 1/4, 1/4 and
1/2), bit for bit.

Each op's CPU implementation is the plain version of the same mask and
share rule; its CUDA one launches the kernel, counted as ``"hex_max_pool"``
and ``"hex_max_pool_backward"`` (``utils.profiling.counts``).
:func:`hex_max_pool` calls the op directly where no gradient is wanted,
else through an autograd function whose backward runs in the span
``hygrid.pool_backward``.  That backward is differentiable in turn
(``create_graph=True``, a gradient penalty): its own backward gathers the
input gradient's cotangent over each window with the same shares, which
gives the plain path's second-order gradient (the sign of a zero aside:
the mask does not say which cells tie within a column that holds no
maximum).
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..utils.profiling import count, span
from . import _build, _ops

__all__ = ["hex_max_pool", "pool_shape", "takes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pool_shape(h: int, w: int, kh: int, kw: int, sh: int,
               sw: int) -> tuple:
    """``(hn, wn)``: the windows of an ``(h, w)`` input without padding or
    ceil mode, as ``hex_pool2d`` counts them."""
    return F._pool_windows(h, w, kh, sh, sw)


def _window_ok(kh, kw, sh, sw) -> bool:
    """Windows of at most 2 x 2 cells that do not overlap."""
    return 1 <= kh <= min(sh, 2) and 1 <= kw <= min(sw, 2)


def takes(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int) -> bool:
    """Whether the kernel pools ``(B, H, W, C)`` ``x`` (no padding, no ceil
    mode): a CUDA float32 or bfloat16 tensor, windows of at most 2 x 2
    cells that do not overlap, and at least one window."""
    return (x.is_cuda and x.dtype in _DTYPES and _window_ok(kh, kw, sh, sw)
            and min(pool_shape(x.shape[1], x.shape[2], kh, kw, sh, sw)) > 0)


def _check_window(kh, kw, sh, sw):
    if not _window_ok(kh, kw, sh, sw):
        raise ValueError(f"hex_max_pool: windows of at most 2 x 2 cells that "
                         f"do not overlap, got kernel {(kh, kw)}, stride "
                         f"{(sh, sw)}")


def _shifts(kh: int, kw: int, device) -> torch.Tensor:
    """``(kh, kw, 1)``: cell ``(i, j)``'s tie bit, ``2i + j``."""
    i = torch.arange(kh, device=device)[:, None, None]
    return 2 * i + torch.arange(kw, device=device)[None, :, None]


def _windows(h, w, kh, kw, sh, sw, device):
    """The window index ``(rows, cols)`` of ``hex_pool2d``'s gather."""
    hn, wn = pool_shape(h, w, kh, kw, sh, sw)
    return F._window_index(hn, wn, kh, kw, sh, sw, sw // 2, device)


def _pool_cpu(x, kh, kw, sh, sw, mask):
    """The op's plain version: ``hex_pool2d``'s values
    (``_window_reduce``), and the tie mask from the gathered windows."""
    _check_window(kh, kw, sh, sw)
    h, w = x.shape[1], x.shape[2]
    out = F._window_reduce(x.permute(0, 3, 1, 2), "max",
                           *pool_shape(h, w, kh, kw, sh, sw), kh, kw, sh, sw,
                           sw // 2, nhwc=True)
    if not mask:
        return out, x.new_empty((0,), dtype=torch.uint8)
    rows, cols = _windows(h, w, kh, kw, sh, sw, x.device)
    win = x[:, rows, cols, :]                          # (B,hn,wn,kh,kw,C)
    nan = torch.isnan(win)
    shift = _shifts(kh, kw, x.device)
    tie = torch.where(nan, -torch.inf, win) == out[:, :, :, None, None, :]
    bits = ((tie.long() << shift) | (nan.long() << (shift + 4))).sum((3, 4))
    return out, bits.to(torch.uint8)


def _pool_cuda(x, kh, kw, sh, sw, mask):
    """The op's launch of ``csrc/hex_pool.cu``'s forward."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"hex_max_pool: the kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("hex_max_pool: x must be a contiguous (B, H, W, C) "
                         "tensor")
    _check_window(kh, kw, sh, sw)
    b, h, w, c = x.shape
    hn, wn = pool_shape(h, w, kh, kw, sh, sw)
    out = x.new_empty((b, hn, wn, c))
    bits = x.new_empty((b, hn, wn, c) if mask else (0,), dtype=torch.uint8)
    if out.numel() == 0:
        return out, bits
    with torch.cuda.device(x.device):
        status = _build.load_library().hg_hex_max_pool(
            x.data_ptr(), out.data_ptr(), bits.data_ptr() if mask else None,
            _DTYPES[x.dtype], b, h, w, c, hn, wn, kh, kw, sh, sw,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "hex_max_pool")
    count("hex_max_pool")
    return out, bits


def _pool_fake(x, kh, kw, sh, sw, mask):
    b, h, w, c = x.shape
    hn, wn = pool_shape(h, w, kh, kw, sh, sw)
    return (x.new_empty((b, hn, wn, c)),
            x.new_empty((b, hn, wn, c) if mask else (0,), dtype=torch.uint8))


def _unpack(mask, kh, kw):
    """``(tie (B,hn,wn,kh,kw,C), nan (same), tied (B,hn,wn,kw,C))``: the
    mask's cells at the window maximum, its NaN cells, and the columns
    that hold a maximum."""
    shift = _shifts(kh, kw, mask.device)
    bits = mask.long()[:, :, :, None, None, :]
    tie = (bits >> shift) & 1 == 1
    return tie, (bits >> (shift + 4)) & 1 == 1, tie.any(3)


def _backward_cpu(gout, mask, h, w, kh, kw, sh, sw):
    """The backward op's plain version: autograd of ``_window_reduce``'s
    two ``amax`` stages (``(grad / ties) * tie`` each), ``where``'s zero at
    NaN cells and the gather's accumulation into zeros, from the mask."""
    _check_window(kh, kw, sh, sw)
    tie, nan, tied = _unpack(mask, kh, kw)
    g = gout[:, :, :, None, :] / tied.sum(3, keepdim=True) * tied
    g = g[:, :, :, None] / tie.sum(3, keepdim=True).clamp(min=1) * tie
    g = torch.where(nan, 0, g)
    rows, cols = _windows(h, w, kh, kw, sh, sw, gout.device)
    dx = gout.new_zeros((gout.shape[0], h, w, gout.shape[-1]))
    return torch.ops.aten.index_put_.default(dx, [None, rows, cols], g, True)


def _backward_cuda(gout, mask, h, w, kh, kw, sh, sw):
    """The backward op's launch of ``csrc/hex_pool.cu``'s backward."""
    if gout.dtype not in _DTYPES:
        raise TypeError(f"hex_max_pool_backward: the kernel takes float32 or "
                        f"bfloat16, got {gout.dtype}")
    _check_window(kh, kw, sh, sw)
    b, hn, wn, c = gout.shape
    if (hn, wn) != pool_shape(h, w, kh, kw, sh, sw) or \
            mask.shape != gout.shape or mask.dtype != torch.uint8 or \
            not (gout.is_contiguous() and mask.is_contiguous()):
        raise ValueError("hex_max_pool_backward: gout and mask must be the "
                         "forward's contiguous (B, hn, wn, C) output and mask")
    dx = gout.new_empty((b, h, w, c))
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(gout.device):
        status = _build.load_library().hg_hex_max_pool_backward(
            gout.data_ptr(), mask.data_ptr(), dx.data_ptr(),
            _DTYPES[gout.dtype], b, h, w, c, hn, wn, kh, kw, sh, sw,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "hex_max_pool_backward")
    count("hex_max_pool_backward")
    return dx


def _backward_fake(gout, mask, h, w, kh, kw, sh, sw):
    return gout.new_empty((gout.shape[0], h, w, gout.shape[-1]))


_OP = _ops.define(
    "hex_max_pool(Tensor x, int kh, int kw, int sh, int sw, bool mask) -> "
    "(Tensor, Tensor)", cpu=_pool_cpu, cuda=_pool_cuda, fake=_pool_fake)
_BACKWARD_OP = _ops.define(
    "hex_max_pool_backward(Tensor gout, Tensor mask, int h, int w, int kh, "
    "int kw, int sh, int sw) -> Tensor",
    cpu=_backward_cpu, cuda=_backward_cuda, fake=_backward_fake)


def _pool_backward(gout, mask, geometry):
    with span("hygrid.pool_backward"):
        return _BACKWARD_OP(gout.contiguous(), mask, *geometry)


def _backward_adjoint(ggx, mask, h, w, kh, kw, sh, sw):
    """The cotangent of ``gout`` from that of the backward's ``dx``: what
    autograd of the plain backward gives, the gather of ``ggx`` over each
    window, zero at NaN cells, summed over the tied cells of a column and
    over their count, then over the tied columns and over theirs."""
    tie, nan, tied = _unpack(mask, kh, kw)
    rows, cols = _windows(h, w, kh, kw, sh, sw, ggx.device)
    g = torch.where(nan, 0, ggx[:, rows, cols, :])     # (B,hn,wn,kh,kw,C)
    g = (g * tie).sum(3) / tie.sum(3).clamp(min=1)
    return (g * tied).sum(3) / tied.sum(3)


class _HexMaxPoolGrad(torch.autograd.Function):
    """The pool's backward where it is to be differentiated: linear in
    ``gout``, its own backward is :func:`_backward_adjoint`."""

    @staticmethod
    def forward(ctx, gout, mask, geometry):
        ctx.save_for_backward(mask)
        ctx.geometry = geometry
        return _pool_backward(gout, mask, geometry)

    @staticmethod
    def backward(ctx, ggx):
        mask, = ctx.saved_tensors
        return _backward_adjoint(ggx, mask, *ctx.geometry), None, None


class _HexMaxPool(torch.autograd.Function):
    """The pool with its tie mask kept for the backward op."""

    @staticmethod
    def forward(ctx, x, kh, kw, sh, sw):
        out, mask = _OP(x, kh, kw, sh, sw, True)
        ctx.save_for_backward(mask)
        ctx.geometry = (x.shape[1], x.shape[2], kh, kw, sh, sw)
        return out

    @staticmethod
    def backward(ctx, gout):
        mask, = ctx.saved_tensors
        if torch.is_grad_enabled():    # create_graph: a differentiable dx
            dx = _HexMaxPoolGrad.apply(gout, mask, ctx.geometry)
        else:
            dx = _pool_backward(gout, mask, ctx.geometry)
        return dx, None, None, None, None


def hex_max_pool(x: torch.Tensor, kernel_size: tuple,
                 stride: tuple) -> torch.Tensor:
    """Max-pool ``(B, H, W, C)`` ``x`` over the brick-lattice windows of
    ``kernel_size`` ``(kh, kw)`` and ``stride`` ``(sh, sw)`` (at most 2 x 2
    cells, not overlapping), no padding: ``(B, hn, wn, C)``, NHWC-contiguous
    (:func:`pool_shape`).  A CUDA tensor (float32 or bfloat16) launches the
    kernel, a CPU tensor runs the plain version; both give
    ``hex_pool2d(x, "max", data_format="NHWC")``'s values and gradient bit
    for bit."""
    (kh, kw), (sh, sw) = kernel_size, stride
    x = x.contiguous()
    if x.requires_grad and torch.is_grad_enabled():
        return _HexMaxPool.apply(x, kh, kw, sh, sw)
    return _OP(x, kh, kw, sh, sw, False)[0]
