"""The single-op hex conv kernel (``csrc/hex_conv_single.cu``): one stride-1
'valid' hex convolution on NCHW data, any input-row parity and dilation.

Port of ``hygrid_tpu/kernels/conv_pallas.py::packed_hex_conv_pallas``,
which runs TPU kernel #7 (``_conv_kernel``) and, for inputs above
``_CONV_BAND_THRESHOLD`` elements or with ``band_rows``, #8
(``_conv_kernel_banded``).  One CUDA kernel computes what both compute;
``band_rows`` keeps only the reference's argument check.  The TPU's lane
packing and Kronecker "shift x tap" matrices are not ported.

:func:`hex_conv_single` takes ``packed_hex_conv_pallas``'s arguments: it
casts ``x`` to the kernel's dtype, pads it with zeros, folds the padding
into the row parity, runs the valid conv and adds the bias after it in the
output dtype (``conv_pallas.py:205-206``).  The conv is the op
``hygrid::hex_conv_single`` (``_ops.py``) inside a
``torch.autograd.Function`` whose backward is the plain VJP (autograd of
:func:`hex_conv_single_plain`'s conv), as the reference pulls back through
XLA's packed conv (``conv_pallas.py:210-229``).  On a CUDA tensor
(float32 or bfloat16) the op launches the kernel, on a CPU tensor it runs
the plain version; anything else raises.

The kernel runs bfloat16 on kernel B's tensor-core tile (the weights
packed by ``conv_stack._pack_mma_weights``, the tile's output channels
chosen by ``conv_stack._tile_n``), bit-equal to ``hex_conv_layer`` on the
padded input, and float32 on a CUDA-core tile that packs output rows
shorter than 64 pixels into one block (:func:`_f32_plan` mirrors the C
entry's choice), bit-equal to ``hex_conv_layer`` in float32.

:func:`takes_single_route` is ``hex_conv2d(impl="pallas")``'s gate: the
reference's envelope (``pallas_conv_applicable``) and height check
(``hygrid_tpu/nn/functional.py:519-521``).  Both are TPU facts, copied only
so that each call runs the counterpart of its TPU kernel; outside them
``hex_conv2d`` runs ``"direct"``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..nn import functional as F
from ..utils.profiling import count
from . import _build, _ops, conv_stack

__all__ = ["hex_conv_single", "hex_conv_single_plain",
           "pallas_conv_applicable", "takes_single_route"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pallas_conv_applicable(c: int, co: int, stride: int, groups: int) -> bool:
    """``conv_pallas.pallas_conv_applicable``: stride 1, groups 1,
    ``128 % C == 0`` and ``Cout * 128 / C <= 512``."""
    return (stride == 1 and groups == 1 and c <= 128 and 128 % c == 0
            and co * (128 // c) <= 512)


def takes_single_route(c: int, co: int, stride: int, groups: int, h: int,
                       radius: int, dilation: int) -> bool:
    """Whether ``hex_conv2d(impl="pallas")`` runs the kernel: the envelope
    and a padded height ``h`` at least the kernel's plus 2."""
    return (pallas_conv_applicable(c, co, stride, groups)
            and h - 2 >= (2 * radius - 2) * dilation + 1)


@functools.lru_cache(maxsize=None)
def _valid_taps(radius: int, dilation: int, parity: int) -> np.ndarray:
    table = np.ascontiguousarray(F.hex_valid_tap_table(radius, dilation,
                                                       parity))
    table.setflags(write=False)
    return table


# the float32 tile (csrc/hex_conv_single.cu): output pixels a block, staged
# input channels, and the shared memory a block may use on the H100
_TILE_P = 64
_CHUNK_C = 16
_MAX_SMEM = 232448


def _patch(table: np.ndarray) -> tuple[int, int]:
    """Rows and columns of the patch one 64-pixel tile reads
    (``hex_common.cuh::make_geometry``)."""
    dr, dc = table[..., 0], table[..., 1]
    return (int(dr.max() - dr.min()) + 1,
            _TILE_P + int(dc.max() - dc.min()))


def _f32_smem(cob: int, n_rows: int, kn: int, nv: int) -> int:
    """Shared memory of the float32 tile: the patch and the weights of one
    16-channel chunk in float32, and the staging table (an 8- and a 4-byte
    entry per staged column)."""
    return 4 * (n_rows * _CHUNK_C * nv + kn * _CHUNK_C * cob) + 12 * nv


def _f32_plan(b: int, cin: int, cout: int, ho: int, wo: int, kn: int,
              n_rows: int, n_cols: int):
    """How the float32 kernel covers the output, as the C entry chooses it
    (``hex_conv_single.cu::f32_packing``): ``cob`` output channels a block
    (16, 32 or 64 from Cout); ``S`` output rows of one parity a block
    (``64 // Wo`` where Wo < 64, each ``sw = Wo`` pixels, else one row's
    64-pixel tile, ``sw = 64``); ``ncs = sw + tap width`` staged columns
    each, ``nv = S * ncs`` in all; where shared memory is short, half the
    channels, else half the rows; ``tiles0`` tiles of even rows and
    ``tiles`` in all.  None where nothing fits."""
    cob = 16 if cout <= 16 else 32 if cout <= 32 else 64
    s = _TILE_P // wo if wo < _TILE_P else 1
    tap_width = n_cols - _TILE_P
    while True:
        sw = wo if s > 1 else _TILE_P
        nv = s * (sw + tap_width)
        if _f32_smem(cob, n_rows, kn, nv) <= _MAX_SMEM:
            break
        if cob > 16:
            cob //= 2
        elif s > 1:
            s //= 2
        else:
            return None
    rows = [b * ((ho + 1 - q) // 2) for q in (0, 1)]
    per_row = 1 if s > 1 else -(-wo // _TILE_P)
    tiles = [-(-r // s) if s > 1 else r * per_row for r in rows]
    return dict(cob=cob, S=s, sw=sw, ncs=sw + tap_width, nv=nv,
                tiles0=tiles[0], tiles=sum(tiles))


def _grid(dtype, b: int, cin: int, cout: int, ho: int, wo: int, kn: int,
          table: np.ndarray):
    """The kernel's grid for these shapes, as the C entry launches it:
    float32, ``(tiles, ceil(Cout / cob))`` of :func:`_f32_plan`; bfloat16,
    ``(ceil(Wo / 64), Ho, B * ceil(Cout / N))`` with kernel B's N
    (``conv_stack._tile_n``).  None where the float32 tile does not fit."""
    n_rows, n_cols = _patch(table)
    if dtype == torch.bfloat16:
        n = conv_stack._tile_n(dtype, cin, cout, kn, n_rows, n_cols)
        return (-(-wo // _TILE_P), ho, b * -(-cout // n))
    plan = _f32_plan(b, cin, cout, ho, wo, kn, n_rows, n_cols)
    return None if plan is None else (plan["tiles"],
                                      -(-cout // plan["cob"]))


def _prepare(x, kernel, even_odd_offset, padding, band_rows):
    """``(padded x in the kernel's dtype, kernel, row parity)``.  A tensor
    ``x`` stays on its device; other input follows the kernel, or goes to
    the card when neither is a tensor."""
    x = F._as_4d(x, F._input_device(x, kernel))
    kernel = torch.as_tensor(kernel, device=x.device)
    if kernel.ndim == 4:
        kernel = kernel[:, :, 0, :]
    x = x.to(kernel.dtype)
    if padding:
        x = torch.nn.functional.pad(x, (padding,) * 4)
    if band_rows is not None and int(band_rows) < 1:
        raise ValueError(f"band_rows must be a positive row count, got "
                         f"{band_rows!r}")
    return x, kernel, (even_odd_offset + padding) % 2


def _add_bias(out, bias):
    if bias is None:
        return out
    bias = torch.as_tensor(bias, device=out.device)
    return out + bias.reshape(1, -1, 1, 1).to(out.dtype)


def _valid_plain(x, kernel, parity, radius, dilation):
    """The valid conv of padded ``x`` by ``hex_conv2d(impl="direct")``,
    computed in at least float32 and returned in x's dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    out = F._hex_conv2d_direct(x.to(ct), kernel.to(ct), None, parity, radius,
                               1, dilation, 1)
    return out.to(x.dtype)


def hex_conv_single_plain(x, kernel, bias=None, *, even_odd_offset: int = 0,
                          radius: int, padding: int = 0, dilation: int = 1,
                          band_rows=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hex_conv_single`, on any device:
    ``hex_conv2d(impl="direct")`` on the same padded input, in float32 (on
    CUDA, cuDNN runs it in TF32 unless ``torch.backends.cudnn.allow_tf32``
    is False), rounded to the kernel's dtype, then the bias."""
    x, kernel, parity = _prepare(x, kernel, even_odd_offset, padding,
                                 band_rows)
    return _add_bias(_valid_plain(x, kernel, parity, radius, dilation), bias)


def _single_fake(x, kernel, parity, radius, dilation):
    b, _, h, w = x.shape
    return x.new_empty((b, kernel.shape[0], *F.hex_conv2d_output_shape(
        h, w, radius, 1, 0, dilation)))


def _launch(x, kernel, parity, radius, dilation):
    """The op's launch: one ``hg_hex_conv_single`` call on padded NCHW
    ``x``, counted as ``"hex_conv_single"`` (``utils.profiling.counts``)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"hex_conv_single: the kernel takes float32 or "
                        f"bfloat16 activations, got {x.dtype}")
    b, cin, h, w = x.shape
    cout, kn = kernel.shape[0], F.hex_kernel_num(radius)
    if tuple(kernel.shape) != (cout, cin, kn) or kernel.device != x.device:
        raise ValueError(f"hex_conv_single: kernel must be ({cout}, {cin}, "
                         f"{kn}) on {x.device}, got {tuple(kernel.shape)} on "
                         f"{kernel.device}")
    ho, wo = F.hex_conv2d_output_shape(h, w, radius, 1, 0, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"hex_conv_single: input ({h}, {w}) too small for "
                         f"radius {radius}, dilation {dilation}")
    table = _valid_taps(radius, dilation, parity)
    grid = _grid(x.dtype, b, cin, cout, ho, wo, kn, table)
    if grid is None or grid[0] > 2 ** 31 - 1 or max(grid[1:]) > 65535:
        raise ValueError(f"hex_conv_single: no grid for Ho={ho}, Wo={wo}, "
                         f"B={b}, Cin={cin}, Cout={cout}, radius {radius}, "
                         f"dilation {dilation}")
    x = x.contiguous()
    wt = kernel.detach().permute(2, 1, 0)                # (kn, Cin, Cout)
    wt = (conv_stack._pack_mma_weights(wt) if x.dtype == torch.bfloat16
          else wt.float().contiguous())
    out = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_hex_conv_single(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], b,
            h, w, cin, ho, wo, cout, kn, table.ctypes.data, stream)
    _build.check(status, "hex_conv_single")
    count("hex_conv_single")
    return out


_OP = _ops.define(
    "hex_conv_single(Tensor x, Tensor kernel, int parity, int radius, "
    "int dilation) -> Tensor",
    cpu=_valid_plain, cuda=_launch, fake=_single_fake)


class _HexConvSingle(torch.autograd.Function):
    """The kernel on padded ``x``; the backward is autograd of the plain
    valid conv (dx on the padded input, which the caller's pad pulls
    back)."""

    @staticmethod
    def forward(ctx, x, kernel, parity, radius, dilation):
        ctx.geometry = (parity, radius, dilation)
        ctx.save_for_backward(x, kernel)
        return _OP(x, kernel, parity, radius, dilation)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        x, kernel = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            ks = kernel.detach().requires_grad_(need[1])
            y = _valid_plain(xs, ks, *ctx.geometry)
            leaves = [t for t in (xs, ks) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, leaves, gout))
        dx = next(grads) if need[0] else None
        dk = next(grads) if need[1] else None
        return dx, dk, None, None, None


def hex_conv_single(x, kernel, bias=None, *, even_odd_offset: int = 0,
                    radius: int, padding: int = 0, dilation: int = 1,
                    band_rows=None) -> torch.Tensor:
    """Stride-1, groups-1 hex conv of ``x`` ``(B, C, H, W)`` with flat hex
    weights ``kernel`` ``(O, C, kn)``: ``hex_conv2d(..., stride=1,
    groups=1)``, returned ``(B, O, H', W')`` in the kernel's dtype and
    differentiable in x, kernel and bias.

    A CPU tensor runs :func:`hex_conv_single_plain`.  A CUDA tensor
    launches ``csrc/hex_conv_single.cu`` (float32 or bfloat16 activations,
    any channel counts; bfloat16 on the tensor cores with the kernel
    rounded to bf16); anything the kernel does not take raises.
    ``band_rows`` (the TPU's row band) computes the same function.
    """
    x, kernel, parity = _prepare(x, kernel, even_odd_offset, padding,
                                 band_rows)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hex_conv_single: no kernel for device {x.device}")
    return _add_bias(_HexConvSingle.apply(x, kernel, parity, radius,
                                          dilation), bias)
