"""Kernel B: the hex conv layer (``csrc/hex_conv_layer.cu``), its backward
(dL/dx through the same conv pass, dL/dW in ``csrc/hex_conv_wgrad.cu``),
the fused norm-free stack (``csrc/hex_conv_fused_stack.cu``) and the 'same'
conv stack built from them.

Port of the stack part of ``hygrid_tpu/kernels/conv_pallas.py``:
:func:`hex_conv_stack` takes ``hex_conv_stack_pallas``'s arguments and runs
one :func:`hex_conv_layer` per layer on NHWC activations, or, with
``fused=True`` on a uniform-width stack of two or more layers, one
:func:`hex_conv_fused_stack` launch.  Each layer is a stride-1 'same' hex
conv (padding ``d*(r-1)``), then bias, an optional norm and an optional
ReLU, as ``_stack_layer_kernel`` computes it:

* ``("gn", G, gamma, beta)`` — per-sample GroupNorm over G channel groups,
  statistics from the float32 pre-activation (``E[x^2] - mean^2`` clamped
  at 0, eps 1e-5);
* ``("affine", scale, shift)`` — per-channel ``x * scale + shift``.

:func:`hex_conv_layer` is a ``torch.autograd.Function`` (the counterpart of
the stack's ``custom_vjp``, ``conv_pallas.py:1266-1362``).  Its forward
keeps the layer input and, for GN layers, the float32 pre-activation the
conv pass writes anyway and the (sample, group) mean and rstd; an affine
layer whose grad is wanted has the conv pass write its float32
pre-activation beside the output too, and a ReLU layer without GN keeps
its output, whose positive entries are the ReLU's mask.  Its backward
pulls the output cotangent back through ReLU / norm / bias, for GN layers with
:func:`gn_relu_backward` (``csrc/gn_backward.cu``: the closed-form vjp of
the reference's tail, where JAX takes ``jax.vjp`` of ``_make_post`` under
XLA), for affine layers with :func:`affine_relu_backward` (plain torch
ops on any device, as the reference's XLA pullback of the same tail), in
the activation dtype, and runs
:func:`hex_conv_layer_dgrad` (dL/dx) and :func:`hex_conv_layer_wgrad`
(dL/dW): the two halves of ``_stack_layer_bwd_kernel``.  Each grad comes
back in its input's dtype.
:func:`hex_conv_fused_stack`'s backward recomputes the stack through
chained :func:`hex_conv_layer` calls, as the reference's VJP recomputes
through ``_stack_xla``.

On CUDA the conv pass runs on the tensor cores in bfloat16
(``hex_common.cuh::conv_tile_mma``, ``wgmma``: the weights rounded to
bf16 and packed by :func:`_pack_mma_weights`, as the TPU kernel rounds
them, the tile's output channels chosen by :func:`_tile_n`) and on the
CUDA cores in float32; so does dL/dW (``wgmma`` GEMMs per tap over the
pixels, in the fixed row chunks of :func:`_wgrad_chunks`), and so does the
fused stack, with the same sums on bands of output rows (its tile chosen
by the C side and reported in ``LAST_FUSED_PLAN``, its weights packed by
:func:`_fused_weights`), so that it equals chained layers bit for bit in
both dtypes.

``band_rows`` selects the TPU's row-banded layer kernel, which exists only
to fit planes larger than VMEM; the port computes the same function with
:func:`hex_conv_layer` and keeps only the reference's argument checks.
The TPU's lane packing, plane margins and in-place aliasing are not
ported: ``packed_io`` raises ``NotImplementedError``.  The split first
layer of a skip-join stage (``extra_input``, ``_stack_layer_kernel`` with
``split=True``) is :func:`hex_conv_layer_split`, the split mode of the
same CUDA source: ``conv(concat(A, B), K)`` with the concatenation never
built.  It is the same ``torch.autograd.Function`` with a second input;
its backward runs :func:`hex_conv_layer_split_dgrad` (dA and dB from the
dgrad pass on ``Ka`` and on ``Kb``) and :func:`hex_conv_layer_split_wgrad`
(the dW kernel on ``(A, gpre)`` and on ``(B, gpre)``, concatenated along
Cin): the reference's own plan for ``_stack_layer_bwd_kernel`` on the
split layer (``conv_pallas.py:2050-2064``), on the unsplit layer's
kernels.

The plain version of a layer is :func:`hex_conv_layer_plain`
(``hex_conv2d(impl="direct")`` + :func:`_group_norm_nchw`, computed in
float32); chained, it is the twin of ``conv_pallas._stack_xla``, and
:func:`hex_conv_fused_stack_plain`.  The plain versions of the backward
kernels are :func:`hex_conv_layer_dgrad_plain` and
:func:`hex_conv_layer_wgrad_plain` (autograd of the plain conv), and
their split twins :func:`hex_conv_layer_split_dgrad_plain` and
:func:`hex_conv_layer_split_wgrad_plain`; of the GN tail's backward,
:func:`gn_relu_backward_plain` on the statistics of :func:`gn_stats_plain`.
Every
wrapper runs its plain version for a CPU tensor, launches its kernel for a
CUDA tensor and raises for anything else.  The forward launches are the
ops ``hygrid::hex_conv_layer`` (a layer or a split layer; its
pre-activation and GN statistics come back as empty tensors where the
layer keeps none) and ``hygrid::hex_conv_fused_stack`` (``_ops.py``), so
that an exported program keeps them; the backward kernels are called
directly (the reference exports inference only).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..nn import functional as F
from ..utils.profiling import count, span
from . import _build, _ops

__all__ = ["hex_conv_layer", "hex_conv_layer_plain", "hex_conv_layer_dgrad",
           "hex_conv_layer_dgrad_plain", "hex_conv_layer_wgrad",
           "hex_conv_layer_wgrad_plain", "hex_conv_fused_stack",
           "hex_conv_fused_stack_plain", "hex_conv_layer_split",
           "hex_conv_layer_split_plain", "hex_conv_layer_split_dgrad",
           "hex_conv_layer_split_dgrad_plain", "hex_conv_layer_split_wgrad",
           "hex_conv_layer_split_wgrad_plain", "gn_stats_plain",
           "gn_relu_backward", "gn_relu_backward_plain",
           "gn_backward_plan", "gn_backward_device",
           "affine_relu_backward", "hex_conv_stack"]

LAST_FUSED_PLAN: dict = {}
"""The tile the C side chose for the last fused-stack launch: ``n`` (the
tile's output channels), ``rows`` (band rows), ``threads`` a block,
``weights`` ("layer" or "chunk"), ``smem`` bytes, ``grid``,
``blocks_per_sm`` and the batch ``group``."""

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EPS = 1e-5
_GN_BWD_THREADS = 512  # a GN backward block's threads where V > 1
_GN_BWD_DEVICE: dict = {}  # device index -> (SMs, shared bytes a block)
# target blocks of the dW partial-sum pass, float32 (CUDA cores) and
# bfloat16 (tensor cores): few, long blocks, so that the f32 partial sums
# each chunk writes and the fold reads stay few
_WGRAD_BLOCKS = 792
# the float32 dW tile (hex_conv_wgrad.cu::WgradTile): taps a block at most
# (one a warp)
_WGRAD_F32_TAPS = 8
# batch elements of one fused-stack group: each of its two scratch buffers
# holds at most this many bytes, so both stay in the card's 50 MB L2
_FUSED_GROUP_BYTES = 16 * 2 ** 20
_FUSED_MAX_LAYERS = 64
# the fused stack's weights modes, as the C side numbers them
_FUSED_WEIGHTS = ("layer", "chunk")
# kernel B's conv tiles (csrc/hex_common.cuh): output columns of a tile row
# and staged input channels, and the shared memory a block may use on the
# H100 (each tile is chosen under it); the float32 tile's output rows for
# each width COB (hex_common.cuh::F32Tile)
_TILE_P = 64
_CHUNK_C = 16
_MMA_MAX_SMEM = 232448
_F32_ROWS = {16: 8, 32: 8, 64: 4}


def _frozen(table: np.ndarray) -> np.ndarray:
    table = np.ascontiguousarray(table)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def _taps(radius: int, dilation: int) -> np.ndarray:
    return _frozen(F.hex_tap_table(radius, dilation))


@functools.lru_cache(maxsize=None)
def _adjoint_taps(radius: int, dilation: int) -> np.ndarray:
    return _frozen(F.hex_adjoint_tap_table(radius, dilation))


@functools.lru_cache(maxsize=None)
def _patch_shape(radius: int, dilation: int, adjoint: bool
                 ) -> tuple[int, int]:
    """Rows and columns of the input patch one 64-pixel tile reads for the
    (adjoint) tap table (``hex_common.cuh::make_geometry``)."""
    table = (_adjoint_taps if adjoint else _taps)(radius, dilation)
    dr, dc = table[..., 0], table[..., 1]
    return (int(dr.max() - dr.min()) + 1,
            _TILE_P + int(dc.max() - dc.min()))


@functools.lru_cache(maxsize=None)
def _mma_patch_shape(radius: int, dilation: int, adjoint: bool
                     ) -> tuple[int, int]:
    """Rows and columns of the patch the bf16 tile stages for the (adjoint)
    tap table: the rows some tap reads (``hex_common.cuh::compact_rows``;
    3 at any dilation of a radius-2 kernel) x :func:`_patch_shape`'s
    columns."""
    table = (_adjoint_taps if adjoint else _taps)(radius, dilation)
    return (len(np.unique(table[..., 0])),
            _patch_shape(radius, dilation, adjoint)[1])


def _mma_smem(cin: int, kn: int, n: int, n_rows: int, n_cols: int) -> int:
    """Shared memory of the bf16 tile (``conv_tile_mma_smem``): two stages
    of patch and weights, one when Cin fits in one 16-channel chunk."""
    stages = 2 if cin > _CHUNK_C else 1
    return stages * 16 * (n_rows * 2 * n_cols + kn * 2 * n)


@functools.lru_cache(maxsize=None)
def _tap_rows(radius: int, dilation: int, adjoint: bool
              ) -> tuple[tuple[int, int], ...]:
    """Each tap's ``(first, last)`` row offset over both parities, for the
    (adjoint) tap table."""
    dr = (_adjoint_taps if adjoint else _taps)(radius, dilation)[..., 0]
    return tuple((int(lo), int(hi)) for lo, hi in
                 zip(dr.min(axis=0), dr.max(axis=0)))


def _band_rows(tap_rows, tg: int) -> int:
    """The most patch rows one group reaches where the taps go in groups of
    ``tg`` (``hex_common.cuh::tap_band_rows``)."""
    return max(max(hi for _, hi in tap_rows[t:t + tg])
               - min(lo for lo, _ in tap_rows[t:t + tg]) + 1
               for t in range(0, len(tap_rows), tg))


def _f32_smem(tg: int, cob: int, stages: int, band: int,
              n_cols: int) -> int:
    """Shared memory of the float32 tile (``conv_tile_smem``): ``stages``
    copies of one 16-channel chunk's patch for a group of ``tg`` taps (the
    tile's rows + band - 1 rows x n_cols columns) and its weights (tg x 16
    x cob)."""
    return 4 * stages * ((_F32_ROWS[cob] + band - 1) * n_cols * _CHUNK_C
                         + tg * _CHUNK_C * cob)


def _f32_tile(cin: int, cout: int, tap_rows, n_cols: int):
    """Kernel B's float32 tile as the C entry chooses it
    (``hex_common.cuh::conv_tile_plan``) for taps reaching ``tap_rows``
    (:func:`_tap_rows`): ``cob`` the least of 16, 32, 64 output channels
    that covers Cout (64 above), ``rows`` output rows of 64 columns a block
    (8, 8, 4), two ``stages`` where Cin spans more than one 16-channel
    chunk; while that does not fit in a block's shared memory, one stage,
    then half the channels; where no tile of all the taps fits, the taps
    in groups of ``taps`` (the most that fit), each group's stage holding
    at most ``band`` rows.  A dict with these keys and ``smem``; None where
    nothing fits."""
    kn = len(tap_rows)
    for tg in range(kn, 0, -1):
        band = _band_rows(tap_rows, tg)
        cob = next((c for c in (16, 32) if cout <= c), 64)
        while cob >= 16:
            for stages in ((2, 1) if cin > _CHUNK_C else (1,)):
                smem = _f32_smem(tg, cob, stages, band, n_cols)
                if smem <= _MMA_MAX_SMEM:
                    return dict(cob=cob, rows=_F32_ROWS[cob], stages=stages,
                                taps=tg, band=band, smem=smem)
            cob //= 2
    return None


def _tile_n(dtype: torch.dtype, cin: int, cout: int, kn: int, n_rows: int,
            n_cols: int, tap_rows=None) -> int:
    """Output channels one block of kernel B's conv pass covers, as the
    C entry chooses them: in float32 :func:`_f32_tile`'s ``cob`` for the
    taps' ``tap_rows`` (default: each tap reaching all ``n_rows``, so that
    the taps never go in groups; raises where no tile fits); in bfloat16
    the least of 16, 32, 64, 128 that covers Cout (128 above), halved
    while the tile's stages do not fit in shared memory
    (``hex_common.cuh::conv_tile_mma_n``)."""
    if dtype != torch.bfloat16:
        plan = _f32_tile(cin, cout, tap_rows or ((0, n_rows - 1),) * kn,
                         n_cols)
        if plan is None:
            raise ValueError(f"hex_conv_layer: no float32 tile of {kn} taps "
                             f"fits in shared memory")
        return plan["cob"]
    n = next((n for n in (16, 32, 64) if cout <= n), 128)
    while n > 16 and _mma_smem(cin, kn, n, n_rows, n_cols) > _MMA_MAX_SMEM:
        n //= 2
    return n


def _pack_mma_weights(wt: torch.Tensor) -> torch.Tensor:
    """The bf16 tile's weights: ``(kn, Cin, Cout)`` rounded to bf16 and
    packed as ``(ceil(Cin / 16), kn, 2, Cout, 8)``: unit ``[c, t, g, co]``
    holds input channels ``16 c + 8 g .. + 7`` of tap t for output channel
    co (zero past Cin), the K-major 16-byte rows the tensor cores read, so
    that a block stages its slab of one chunk with plain copies.  Leading
    dimensions (the fused stack's layers) are kept in front."""
    *lead, kn, cin, cout = wt.shape
    chunks = -(-cin // _CHUNK_C)
    packed = torch.zeros((*lead, kn, chunks * _CHUNK_C, cout),
                         dtype=torch.bfloat16, device=wt.device)
    packed[..., :cin, :] = wt
    d = len(lead)
    return packed.view(*lead, kn, chunks, 2, 8, cout).permute(
        *range(d), d + 1, d, d + 2, d + 4, d + 3).contiguous()


def _fused_weights(kernels, dtype) -> torch.Tensor:
    """The fused stack's weights: float32 ``(L, kn, C, C)``; for bfloat16
    every layer packed by :func:`_pack_mma_weights` in one pass, ``(L,
    ceil(C / 16), kn, 2, C, 8)``."""
    wt = torch.stack([k.detach() for k in kernels]).permute(0, 3, 2, 1)
    if dtype == torch.bfloat16:
        return _pack_mma_weights(wt)
    return wt.float().contiguous()                      # (L, kn, Cin, Cout)


def _group_norm_nchw(v: torch.Tensor, groups: int, gamma, beta,
                     eps: float = _EPS) -> torch.Tensor:
    """Plain per-sample GroupNorm on (B, C, H, W), statistics in float32
    (twin of ``conv_pallas._group_norm_nchw``)."""
    b, c, h, w = v.shape
    g = v.reshape(b, groups, (c // groups) * h * w).float()
    mean = g.mean(dim=-1)
    var = g.var(dim=-1, unbiased=False)
    mean = mean.repeat_interleave(c // groups, dim=1)[:, :, None, None]
    inv = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)[
        :, :, None, None]
    out = (v.float() - mean) * inv
    out = out * gamma.float()[None, :, None, None] \
        + beta.float()[None, :, None, None]
    return out.to(v.dtype)


def _pre_plain_taps(x, kernel, radius: int, dilation: int) -> torch.Tensor:
    """The float32 'same' conv of NHWC ``x`` as a sum over the tap table's
    shifted windows, one matmul a row parity: what a dilated layer's plain
    version computes, where ``hex_conv2d``'s dense masked kernel would hold
    ``(2 d (r - 1) + 1)^2`` weights a channel pair for ``3 r^2 - 3 r + 1``
    taps."""
    b, h, w, cin = x.shape
    table = _taps(radius, dilation)
    p = int(np.abs(table).max())
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p, p, p))
    wt = kernel.float().permute(2, 1, 0).reshape(-1, kernel.shape[0])
    out = xp.new_zeros((b, h, w, kernel.shape[0]))
    for q in (0, 1):
        rows = torch.arange(q, h, 2, device=x.device)
        if not len(rows):
            continue
        win = torch.stack([xp[:, rows + p + int(dr), p + int(dc):
                              p + int(dc) + w] for dr, dc in table[q]], 3)
        out[:, q::2] = win.flatten(3) @ wt
    return out


def _pre_plain(x, kernel, bias, radius: int, dilation: int) -> torch.Tensor:
    """The float32 pre-activation ``conv(x) + bias`` of a layer, NHWC; a
    dilated layer's by :func:`_pre_plain_taps`."""
    if dilation > 1:
        h = _pre_plain_taps(x, kernel, radius, dilation)
        return h if bias is None else h + bias.float()
    h = F.hex_conv2d(x.permute(0, 3, 1, 2).float(), kernel.float(),
                     None if bias is None else bias.float(),
                     even_odd_offset=0, radius=radius,
                     padding=dilation * (radius - 1), dilation=dilation,
                     impl="direct")
    return h.permute(0, 2, 3, 1)


def _post_plain(y, norm, relu: bool, dtype) -> torch.Tensor:
    """The tail of a layer on its float32 NHWC pre-activation: norm, ReLU,
    rounding to ``dtype``."""
    h = y.permute(0, 3, 1, 2)
    if norm is not None:
        if norm[0] == "gn":
            _, groups, gamma, beta = norm
            h = _group_norm_nchw(h, groups, gamma, beta)
        else:
            _, scale, shift = norm
            h = h * scale.float()[None, :, None, None] \
                + shift.float()[None, :, None, None]
    if relu:
        h = torch.relu(h)
    return h.permute(0, 2, 3, 1).to(dtype).contiguous()


def gn_stats_plain(y: torch.Tensor, groups: int, eps: float = _EPS):
    """``(mean, rstd)``, float32 ``(B, G)``, of the NHWC pre-activation
    ``y`` per (sample, group), as the reference's in-kernel GN computes them
    (``conv_pallas.py:1774-1786``) and kernel B's stats fold does: ``var =
    E[y^2] - mean^2`` clamped at 0, eps added before rsqrt.  The statistics
    the CPU forward saves for :func:`gn_relu_backward`."""
    b, c = y.shape[0], y.shape[-1]
    g = y.float().reshape(b, -1, groups, c // groups)
    n = g.shape[1] * g.shape[3]
    mean = g.sum((1, 3)) / n
    var = torch.clamp_min((g * g).sum((1, 3)) / n - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def gn_relu_backward_plain(y, mean, rstd, gamma, beta, gout, groups: int,
                           relu: bool, eps: float = _EPS):
    """Plain version of :func:`gn_relu_backward`, on any device: the
    closed-form vjp of ``act(GroupNorm(y))`` (``E[y^2] - mean^2`` with its
    clamp, the reference's ``_make_post``) at the saved statistics, in
    float32.  Returns ``(gpre, dgamma, dbeta, dbias)``: the pre-activation
    cotangent in gout's dtype, and float32 ``(C,)`` sums (``dbias`` from
    the float32 ``gpre``).

    With ``scale = rstd gamma``, ``shift = beta - mean scale``, ``dz =
    gout`` where ``fmaf(y, scale, shift) > 0``, the kernel's forward output
    (all of it without ReLU) and ``yhat
    = (y - mean) rstd``: ``gpre = scale dz - rstd (A + f Bs yhat) / n``,
    ``A`` and ``Bs`` the group's sums of ``gamma dz`` and ``gamma dz yhat``,
    ``n`` its pixels x channels and ``f`` 0 where the variance sat at the
    clamp (``rstd`` equal to ``eps**-0.5``), else 1."""
    b, h, w, c = y.shape
    cpg = c // groups
    n = float(h * w * cpg)
    yg = y.float().reshape(b, h * w, groups, cpg)
    gam = gamma.float().reshape(groups, cpg)
    m = mean.float()[:, None, :, None]
    r = rstd.float()[:, None, :, None]
    scale = r * gam
    shift = beta.float().reshape(groups, cpg) - m * scale
    d = gout.float().reshape(b, h * w, groups, cpg)
    if relu:
        # the sign of fmaf(y, scale, shift), the kernel's: the float32
        # product is exact in float64, and the float64 sum has the sign of
        # the exact one
        pre = yg.double() * scale.double() + shift.double()
        d = torch.where(pre > 0, d, torch.zeros_like(d))
    yhat = (yg - m) * r
    sd, sdy = d.sum(1), (d * yhat).sum(1)                   # (B, G, cpg)
    f = (rstd.float() < torch.rsqrt(torch.tensor(eps))).float()
    a1 = rstd.float() * (gam * sd).sum(-1) / n              # (B, G)
    a2 = f * rstd.float() * (gam * sdy).sum(-1) / n
    gpre = scale * d - (a1[:, None, :, None] + a2[:, None, :, None] * yhat)
    return (gpre.reshape(b, h, w, c).to(gout.dtype), sdy.sum(0).reshape(c),
            sd.sum(0).reshape(c), gpre.sum((0, 1)).reshape(c))


class GnBackwardPlan(NamedTuple):
    """How ``csrc/gn_backward.cu`` walks a call (:func:`gn_backward_plan`).

    ``v`` channels a thread vector and ``threads`` a block
    (:func:`gn_backward_layout`); a sample's pixels cut in ``chunks`` runs
    of ``chunk_px`` (the last shorter), each staged in a block's shared
    memory up to ``staged_px`` (the rest read from device memory in both
    passes); ``spw`` samples a wave, one chunk a block, so ``grid = spw x
    chunks`` blocks and ``waves = ceil(B / spw)`` items a block; ``stages``
    buffers a block (2: the next wave's chunk copies while this one runs);
    ``smem`` dynamic shared bytes a block."""
    v: int
    threads: int
    chunk_px: int
    staged_px: int
    chunks: int
    spw: int
    waves: int
    stages: int
    smem: int
    grid: int


def gn_backward_layout(c: int, aligned: bool = True):
    """``(V, threads, rows)`` of a GN backward block at ``c`` channels:
    ``V`` channels a thread vector (4 where ``c % 4 == 0`` and the tensors
    are 16-byte aligned, else 1); ``c / V`` vectors a pixel times ``k``
    pixel rows of threads (512, or ``c`` where ``V = 1`` and ``c > 512``);
    ``rows`` rows of per-channel sums left after the warp shuffles (one a
    warp where a warp holds whole pixel rows, else one a pixel row).  The
    C side's ``layout``."""
    v = 4 if aligned and c % 4 == 0 else 1
    cvs = c // v
    k = 1 if cvs >= _GN_BWD_THREADS else _GN_BWD_THREADS // cvs
    shuffle = cvs < 32 and 32 % cvs == 0
    return v, cvs * k, (cvs * k // 32 if shuffle else k)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def gn_backward_smem(c: int, gout_bytes: int, threads: int, rows: int,
                     staged_px: int, stages: int) -> int:
    """Dynamic shared bytes of a GN backward block: ``stages`` buffers of a
    chunk's staged y (float32) and gout and the sample's mean and rstd (C
    floats each, G of them used), each 16-byte padded; two floats a
    channel for each of ``rows``, at least 4 a thread (the folds' slices);
    16 bytes of flags; the sample's two per-channel sums, its per-group
    coefficients and gamma (5 C floats).  The C side's ``smem_bytes``."""
    stage = (_pad16(staged_px * c * 4) + _pad16(staged_px * c * gout_bytes)
             + _pad16(8 * c))
    return (stages * stage + _pad16(4 * max(2 * rows * c, 4 * threads))
            + 16 + 20 * c)


@functools.lru_cache(maxsize=256)
def gn_backward_plan(b: int, hw: int, c: int, gout_bytes: int, sms: int,
                     smem_limit: int, aligned: bool = True
                     ) -> GnBackwardPlan:
    """The GN backward's walk at ``b`` samples of ``hw`` pixels x ``c``
    channels, gout ``gout_bytes`` an element, on a card of ``sms`` SMs
    whose blocks may take ``smem_limit`` bytes of shared memory (one
    block an SM).

    A wave holds whole samples (a block spins on its sample's fold, which
    needs every chunk of the sample resident), so a chunk is at most what
    a block stages.  Two stages where a sample fits ``sms`` blocks' halves,
    else one; as many samples a wave as fit, the waves then evened out,
    and the chunks cut so that a wave fills the grid.  A sample larger than
    every block's whole shared memory runs one a wave, each chunk staging
    what fits.  Raises ValueError where a block cannot stage one pixel."""
    v, threads, rows = gn_backward_layout(c, aligned)

    def smem(px, stages):
        return gn_backward_smem(c, gout_bytes, threads, rows, px, stages)

    def capacity(stages):
        px = max(0, (smem_limit - smem(0, stages))
                 // (stages * c * (4 + gout_bytes)))
        while px and smem(px, stages) > smem_limit:
            px -= 1
        return px

    def plan(chunks, spw, staged_cap, stages):
        chunk_px = -(-hw // chunks)
        staged = min(chunk_px, staged_cap)
        chunks = -(-hw // chunk_px)
        return GnBackwardPlan(v, threads, chunk_px, staged, chunks, spw,
                              -(-b // spw), stages, smem(staged, stages),
                              spw * chunks)

    for stages in (2, 1):
        cap = capacity(stages)
        need = -(-hw // cap) if cap else sms + 1   # chunks a sample needs
        if need <= sms:
            spw = min(b, sms // need)
            spw = -(-b // -(-b // spw))
            return plan(min(hw, sms // spw), spw, cap, stages)
    cap = capacity(1)
    if not cap:
        raise ValueError(f"gn_relu_backward: a block cannot stage one pixel "
                         f"of {c} channels in {smem_limit} bytes")
    return plan(min(hw, sms), 1, cap, 1)


def gn_backward_scratch(plan: GnBackwardPlan, b: int, c: int) -> int:
    """4-byte words of a call's scratch: the chunks' (2, C) sums, the
    samples' (2, C) sums, the blocks' (C,) sums, then B + 1 counters."""
    return 2 * b * plan.chunks * c + 2 * b * c + plan.grid * c + b + 1


def gn_backward_device(device) -> tuple:
    """``(SMs, shared bytes a block may opt in to)`` of a CUDA device,
    queried once; raises where it cannot run cooperative launches."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _GN_BWD_DEVICE:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            _build.check(_build.load_library().hg_gn_backward_device(out),
                         "gn_backward_device")
        if not out[2]:
            raise RuntimeError(f"gn_relu_backward: cuda:{index} cannot run "
                               "cooperative launches")
        _GN_BWD_DEVICE[index] = (out[0], out[1])
    return _GN_BWD_DEVICE[index]


def _stat_views(mean, rstd, b, groups):
    """``(mean, rstd, stride)``: the float32 statistics as the kernel reads
    them, (sample, group) at ``(b G + g) stride``; the forward's ``stats[...,
    0]`` and ``stats[..., 1]`` are read in place (stride 2)."""
    if (mean.dtype == rstd.dtype == torch.float32
            and mean.stride() == rstd.stride() and mean.stride(1) >= 1
            and mean.stride(0) == groups * mean.stride(1)):
        return mean, rstd, mean.stride(1)
    return mean.float().contiguous(), rstd.float().contiguous(), 1


def gn_relu_backward(y, mean, rstd, gamma, beta, gout, groups: int,
                     relu: bool):
    """The backward of a GN layer's tail ``act(GroupNorm(y))``: NHWC float32
    pre-activation ``y`` ``(B, H, W, C)``, its saved float32 ``mean`` and
    ``rstd`` ``(B, G)``, ``gamma`` and ``beta`` ``(C,)``, and the output
    cotangent ``gout`` ``(B, H, W, C)``.  Returns ``(gpre, dgamma, dbeta,
    dbias)`` as :func:`gn_relu_backward_plain` does.

    A CPU tensor runs :func:`gn_relu_backward_plain`.  A CUDA tensor (gout
    float32 or bfloat16, C <= 2048, a multiple of 4 above 1024) launches
    ``csrc/gn_backward.cu`` once
    (one cooperative pass over ``(y, gout)`` staged in shared memory, walked
    as :func:`gn_backward_plan` says, with fixed-order folds; counted as
    ``"gn_relu_backward"``); anything else raises, as does a device that
    cannot run the launch."""
    if y.device.type == "cpu":
        return gn_relu_backward_plain(y, mean, rstd, gamma, beta, gout,
                                      groups, relu)
    what = "gn_relu_backward"
    if y.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {y.device}")
    _check_activations(gout, what)
    b, h, w, c = gout.shape
    if (y.dtype != torch.float32 or y.shape != gout.shape
            or not y.is_contiguous() or y.device != gout.device):
        raise ValueError(f"{what}: y must be a contiguous float32 "
                         f"{tuple(gout.shape)} tensor on {gout.device}")
    _check_gn_channels(c, groups, what)
    if c > 1024 and gout.data_ptr() % 16:
        gout = gout.clone()     # above 1024 channels the vectors are aligned
    if mean.shape != (b, groups) or rstd.shape != (b, groups):
        raise ValueError(f"{what}: mean and rstd must be ({b}, {groups})")
    mean, rstd, stride = _stat_views(mean, rstd, b, groups)
    gamma = _check_param(gamma, "gamma", c, y.device)
    beta = _check_param(beta, "beta", c, y.device)
    gpre = torch.empty_like(gout)
    aligned = all(t.data_ptr() % 16 == 0 for t in (y, gout, gpre))
    plan = gn_backward_plan(b, h * w, c, gout.element_size(),
                            *gn_backward_device(y.device), aligned)
    n_scratch = gn_backward_scratch(plan, b, c)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=y.device)
    grads = torch.empty((3, c), dtype=torch.float32, device=y.device)
    fields = (ctypes.c_int * 8)(plan.v, plan.threads, plan.chunk_px,
                                plan.staged_px, plan.chunks, plan.spw,
                                plan.stages, plan.smem)
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_gn_relu_backward(
            y.data_ptr(), gout.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            stride, gamma.data_ptr(), beta.data_ptr(), scratch.data_ptr(),
            n_scratch, gpre.data_ptr(), grads.data_ptr(), _DTYPES[gout.dtype],
            b, h * w, c, groups, int(relu), _EPS, fields, stream)
    _build.check(status, what)
    count("gn_relu_backward")
    return gpre, grads[0], grads[1], grads[2]


def affine_relu_backward(y, scale, gout, out=None):
    """The backward of an affine layer's tail ``act(y * scale + shift)``:
    NHWC float32 pre-activation ``y`` ``(B, H, W, C)``, ``scale`` ``(C,)``,
    the output cotangent ``gout`` and, for a ReLU layer, the layer's output
    ``out``, whose positive entries pass the cotangent (None: no ReLU).
    Returns ``(gpre, dscale, dshift, dbias)``: the pre-activation cotangent
    in gout's dtype, and float32 ``(C,)`` sums (``dbias`` from the float32
    ``gpre``), as ``jax.vjp`` of the reference's ``_make_post`` gives them.

    Plain torch ops on any device: the reference pulls this tail back under
    XLA (``conv_pallas.py:2023-2029``), not in a Pallas kernel."""
    sc = scale.float()
    d = gout.float()
    if out is not None:
        d = torch.where(out > 0, d, torch.zeros_like(d))
    gpre = d * sc
    return (gpre.to(gout.dtype), (d * y).sum((0, 1, 2)), d.sum((0, 1, 2)),
            gpre.sum((0, 1, 2)))


def hex_conv_layer_plain(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                         radius: int, dilation: int = 1, norm=None,
                         relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`hex_conv_layer`, on any device.

    Computes in float32 (the kernel's accumulation type) and returns the
    input's dtype.  On CUDA, ``torch.nn.functional.conv2d`` runs in TF32
    unless ``torch.backends.cudnn.allow_tf32`` is False.
    """
    return _post_plain(_pre_plain(x, kernel, bias, radius, dilation), norm,
                       relu, x.dtype)


def hex_conv_layer_dgrad_plain(gpre: torch.Tensor, kernel: torch.Tensor, *,
                               radius: int, dilation: int = 1
                               ) -> torch.Tensor:
    """Plain version of :func:`hex_conv_layer_dgrad`: autograd of the plain
    conv with respect to its input, in float32, returned in ``gpre``'s
    dtype."""
    b, h, w, _ = gpre.shape
    x = torch.zeros((b, h, w, kernel.shape[1]), dtype=torch.float32,
                    device=gpre.device, requires_grad=True)
    with torch.enable_grad():
        y = _pre_plain(x, kernel.detach(), None, radius, dilation)
        (dx,) = torch.autograd.grad(y, x, gpre.float())
    return dx.to(gpre.dtype)


def hex_conv_layer_wgrad_plain(x: torch.Tensor, gpre: torch.Tensor, *,
                               radius: int, dilation: int = 1
                               ) -> torch.Tensor:
    """Plain version of :func:`hex_conv_layer_wgrad`: autograd of the plain
    conv with respect to its flat hex weights, float32 ``(Cout, Cin, kn)``."""
    k = torch.zeros((gpre.shape[-1], x.shape[-1], F.hex_kernel_num(radius)),
                    dtype=torch.float32, device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = _pre_plain(x.detach(), k, None, radius, dilation)
        (dk,) = torch.autograd.grad(y, k, gpre.float())
    return dk


def hex_conv_layer_split_dgrad_plain(gpre: torch.Tensor, kernel: torch.Tensor,
                                     ca: int, *, radius: int,
                                     dilation: int = 1):
    """Plain version of :func:`hex_conv_layer_split_dgrad`:
    :func:`hex_conv_layer_dgrad_plain` on the unsplit kernel, its
    ``(B, H, W, Ca + Cb)`` result cut at channel ``ca``."""
    dx = hex_conv_layer_dgrad_plain(gpre, kernel, radius=radius,
                                    dilation=dilation)
    return dx[..., :ca].contiguous(), dx[..., ca:].contiguous()


def hex_conv_layer_split_wgrad_plain(a: torch.Tensor, b: torch.Tensor,
                                     gpre: torch.Tensor, *, radius: int,
                                     dilation: int = 1) -> torch.Tensor:
    """Plain version of :func:`hex_conv_layer_split_wgrad`:
    :func:`hex_conv_layer_wgrad_plain` on ``torch.cat([a, b], -1)``."""
    return hex_conv_layer_wgrad_plain(torch.cat([a, b], dim=-1), gpre,
                                      radius=radius, dilation=dilation)


_GN_MAX_C = 2048


def _check_gn_channels(c: int, groups: int, what: str) -> None:
    """GroupNorm's kernels take ``groups | C <= 2048``, and above 1024
    channels ``C % 4 == 0``: a thread of their passes holds a vector of 4
    (or 8) channels, and a block holds at most 1024 threads."""
    if c % groups or c > _GN_MAX_C or (c > 1024 and c % 4):
        raise ValueError(f"{what}: GroupNorm needs groups | C <= "
                         f"{_GN_MAX_C} (a multiple of 4 above 1024), got "
                         f"{groups} groups, C={c}")


def _check_param(t, name, n, device):
    if t is None:
        return None
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"hex_conv_layer: {name} must be ({n},) on {device}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _check_activations(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16 "
                        f"activations, got {t.dtype}")
    if t.ndim != 4 or not t.is_contiguous():
        raise ValueError(f"{what}: activations must be a contiguous "
                         "(B, H, W, C) tensor")


def _check_kernel(kernel, shape, device, what: str) -> None:
    if tuple(kernel.shape) != shape or kernel.device != device:
        raise ValueError(f"{what}: kernel must be {shape} on {device}, got "
                         f"{tuple(kernel.shape)} on {kernel.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _conv_launch(x, wt, cout, taps_key, what, bias=None, norm=None,
                 relu=False, x2=None, save_pre=False):
    """One ``hg_hex_conv_layer`` call on checked NHWC ``x`` with weights
    ``wt`` ``(kn, Cin, Cout)`` (any float dtype; passed as float32 for
    float32 ``x``, packed by :func:`_pack_mma_weights` for bfloat16) and
    the tap table of ``taps_key`` ``(radius, dilation, adjoint)``; with
    ``x2`` (checked, same batch, spatial shape and dtype) the split layer
    on the channel concatenation of ``x`` and ``x2``.  Returns ``(out, y,
    stats)``: for a GN layer the float32 pre-activation and ``(B, G, 2)``
    mean and rstd the kernel computed; for an affine layer with
    ``save_pre`` the pre-activation and None; else None."""
    b, h, w, ca = x.shape
    cin = ca + (0 if x2 is None else x2.shape[-1])
    kn = wt.shape[0]
    patch = (_mma_patch_shape if x.dtype == torch.bfloat16
             else _patch_shape)(*taps_key)
    n = _tile_n(x.dtype, cin, cout, kn, *patch, _tap_rows(*taps_key))
    if h > 65535 or b * math.ceil(cout / n) > 65535:
        raise ValueError(f"{what}: grid too large for H={h}, B={b}, "
                         f"Cout={cout}")
    if x.dtype == torch.bfloat16:
        wt = _pack_mma_weights(wt)
    else:
        wt = wt.float().contiguous()
    radius, dilation, adjoint = taps_key
    taps = (_adjoint_taps if adjoint else _taps)(radius, dilation)
    bias = _check_param(bias, "bias", cout, x.device)
    scale = shift = gamma = beta = y = part = stats = None
    groups = n_part = 0
    if norm is not None and norm[0] == "gn":
        _, groups, gamma, beta = norm
        _check_gn_channels(cout, groups, what)
        gamma = _check_param(gamma, "gamma", cout, x.device)
        beta = _check_param(beta, "beta", cout, x.device)
        y = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
        # the conv epilogue's sums: one pair per (sample, row, 64-column
        # tile, segment of gcd(Cout / G, N) channels)
        seg = math.gcd(cout // groups, n)
        n_part = 2 * b * h * -(-w // _TILE_P) * (cout // seg)
        part = torch.empty(n_part, dtype=torch.float32, device=x.device)
        stats = torch.empty((b, groups, 2), dtype=torch.float32,
                            device=x.device)
    elif norm is not None:
        _, scale, shift = norm
        scale = _check_param(scale, "scale", cout, x.device)
        shift = _check_param(shift, "shift", cout, x.device)
        if save_pre:
            y = torch.empty((b, h, w, cout), dtype=torch.float32,
                            device=x.device)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_hex_conv_layer(
            x.data_ptr(), _ptr(x2), ca, wt.data_ptr(), _ptr(bias),
            _ptr(scale), _ptr(shift), _ptr(gamma), _ptr(beta), groups, _EPS,
            _ptr(y), _ptr(part), _ptr(stats), n_part, out.data_ptr(),
            _DTYPES[x.dtype], b, h, w, cin, cout, kn, taps.ctypes.data,
            int(relu), stream)
    _build.check(status, what)
    return out, y, stats


def _check_pair(a, b, what) -> None:
    """Checked NHWC ``a`` and ``b`` sharing (B, H, W), dtype and device."""
    _check_activations(a, what)
    _check_activations(b, what)
    if (b.shape[:3] != a.shape[:3] or b.dtype != a.dtype
            or b.device != a.device):
        raise ValueError(f"{what}: {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype} must share (B, H, W), "
                         "dtype and device")


def _layer_forward(x, kernel, bias, radius, dilation, norm, relu, x2=None,
                   save_pre=False):
    """:func:`_layer_op` with the layer's norm as a ``norm`` tuple (None,
    ``("gn", groups, gamma, beta)`` or ``("affine", scale, shift)``)."""
    kind = None if norm is None else norm[0]
    groups = int(norm[1]) if kind == "gn" else 0
    p, q = (None, None) if norm is None else norm[-2:]
    return _layer_op(x, x2, kernel, bias, p, q, radius, dilation, kind,
                     groups, relu, save_pre)


def _layer_op(x, x2, kernel, bias, p, q, radius, dilation, kind, groups,
              relu, save_pre):
    """``(out, y, stats)`` of one layer, or with ``x2`` of the split layer
    on the channel concatenation of ``x`` and ``x2``, through the op
    ``hygrid::hex_conv_layer``: ``y`` is its float32 NHWC pre-activation
    for GN layers and, with ``save_pre``, affine layers (None otherwise),
    ``stats`` a GN layer's float32 ``(B, G, 2)`` mean and rstd (None
    without GN)."""
    out, y, stats = _LAYER_OP(x, x2, kernel, bias, p, q, radius, dilation,
                              kind, groups, bool(relu), bool(save_pre))
    return (out, y if _keeps_pre(kind, save_pre) else None,
            stats if kind == "gn" else None)


def _keeps_pre(kind, save_pre: bool) -> bool:
    """Whether a layer returns its float32 pre-activation: GN layers (their
    backward reads it), affine layers whose grad is wanted."""
    return kind == "gn" or (kind == "affine" and save_pre)


def _norm_spec(kind, groups, p, q):
    return (None if kind is None else ("gn", groups, p, q) if kind == "gn"
            else ("affine", p, q))


def _layer_cpu(x, x2, kernel, bias, p, q, radius, dilation, kind, groups,
               relu, save_pre):
    """The op's plain version: :func:`hex_conv_layer_plain` (on the
    concatenation for the split layer), with the pre-activation and the GN
    statistics by the kernel's formula (:func:`gn_stats_plain`), or empty
    tensors where the CUDA launch has none."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    y = _pre_plain(xin, kernel, bias, radius, dilation)
    stats = (torch.stack(gn_stats_plain(y, groups), -1) if kind == "gn"
             else y.new_empty(0))
    out = _post_plain(y, _norm_spec(kind, groups, p, q), relu, xin.dtype)
    # NHWC-contiguous, as the launch writes it (the fake's strides)
    return (out, y.contiguous() if _keeps_pre(kind, save_pre)
            else y.new_empty(0), stats)


def _layer_cuda(x, x2, kernel, bias, p, q, radius, dilation, kind, groups,
                relu, save_pre):
    """The op's launch of kernel B (its split mode with ``x2``), counted as
    ``"hex_conv_layer"`` (``"hex_conv_layer_split"``); a GN layer is three
    CUDA launches and counts once."""
    what = "hex_conv_layer" if x2 is None else "hex_conv_layer_split"
    if x2 is None:
        _check_activations(x, what)
    else:
        _check_pair(x, x2, what)
    cin = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
    cout = kernel.shape[0]
    _check_kernel(kernel, (cout, cin, F.hex_kernel_num(radius)), x.device,
                  what)
    wt = kernel.permute(2, 1, 0)                            # (kn, Cin, Cout)
    out, y, stats = _conv_launch(x, wt, cout, (radius, dilation, False),
                                 what, bias, _norm_spec(kind, groups, p, q),
                                 relu, x2=x2, save_pre=save_pre)
    count(what)

    def empty():
        return torch.empty(0, dtype=torch.float32, device=x.device)

    return (out, empty() if y is None else y,
            empty() if stats is None else stats)


def _layer_fake(x, x2, kernel, bias, p, q, radius, dilation, kind, groups,
                relu, save_pre):
    pre = (*x.shape[:3], kernel.shape[0])
    f32 = torch.float32
    return (x.new_empty(pre),
            x.new_empty(pre if _keeps_pre(kind, save_pre) else 0, dtype=f32),
            x.new_empty((x.shape[0], groups, 2) if kind == "gn" else 0,
                        dtype=f32))


_LAYER_OP = _ops.define(
    "hex_conv_layer(Tensor x, Tensor? x2, Tensor kernel, Tensor? bias, "
    "Tensor? p, Tensor? q, int radius, int dilation, str? kind, int groups, "
    "bool relu, bool save_pre) -> (Tensor, Tensor, Tensor)",
    cpu=_layer_cpu, cuda=_layer_cuda, fake=_layer_fake)


class _HexConvLayer(torch.autograd.Function):
    """One layer with GN (``kind`` "gn", ``p, q`` gamma and beta), the
    per-channel affine (``kind`` "affine", ``p, q`` scale and shift) or
    without a norm (``kind`` None), on ``x`` or, with ``x2`` not None, on
    the concatenation of ``x`` and ``x2`` (the split layer); see the module
    docstring for the backward.  ``save_pre``: an affine layer keeps its
    float32 pre-activation (its grad is wanted)."""

    @staticmethod
    def forward(ctx, x, x2, kernel, bias, p, q, radius, dilation, kind,
                groups, relu, save_pre):
        out, y, stats = _layer_op(x, x2, kernel, bias, p, q, radius,
                                  dilation, kind, groups, relu, save_pre)
        ctx.geometry = (radius, dilation, kind, groups, relu)
        # normed layers pull back through their pre-activation (and GN's
        # statistics), ReLU layers without GN through the mask of their
        # output
        ctx.save_for_backward(x, x2, kernel, bias, p, q,
                              None if kind is None else y,
                              out if relu and kind != "gn" else None, stats)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        x, x2, kernel, bias, p, q, y, out, stats = ctx.saved_tensors
        radius, dilation, kind, groups, relu = ctx.geometry
        dp = dq = None
        if kind is not None:
            if kind == "gn":
                with span("hygrid.gn_backward"):
                    gpre, dp, dq, dbias = gn_relu_backward(
                        y, stats[..., 0], stats[..., 1], p, q,
                        gout.contiguous(), groups, relu)
            else:
                gpre, dp, dq, dbias = affine_relu_backward(y, p, gout, out)
            gpre = gpre.to(x.dtype).contiguous()
            dp, dq = dp.to(p.dtype), dq.to(q.dtype)
        else:
            g32 = gout.float() * (out > 0) if relu else gout.float()
            gpre = g32.to(x.dtype).contiguous()
            dbias = g32.sum((0, 1, 2))
        need = ctx.needs_input_grad
        kw = dict(radius=radius, dilation=dilation)
        dx = dx2 = dk = None
        if x2 is None:
            if need[0]:
                dx = hex_conv_layer_dgrad(gpre, kernel, **kw)
            if need[2]:
                dk = hex_conv_layer_wgrad(x, gpre, **kw)
        else:
            if need[0] or need[1]:
                dx, dx2 = hex_conv_layer_split_dgrad(gpre, kernel,
                                                     x.shape[-1], **kw)
                dx, dx2 = (dx if need[0] else None,
                           dx2 if need[1] else None)
            if need[2]:
                dk = hex_conv_layer_split_wgrad(x, x2, gpre, **kw)
        db = (dbias.to(bias.dtype)
              if bias is not None and need[3] else None)
        return (dx, dx2, None if dk is None else dk.to(kernel.dtype), db,
                dp, dq, None, None, None, None, None, None)


def _apply_layer(x, x2, kernel, bias, radius, dilation, norm, relu):
    """:class:`_HexConvLayer` on a layer's arguments (``norm`` None,
    ``("gn", G, gamma, beta)`` or ``("affine", scale, shift)``)."""
    kind = None if norm is None else norm[0]
    groups = int(norm[1]) if kind == "gn" else 0
    p, q = (None, None) if norm is None else norm[-2:]
    save_pre = kind == "affine" and torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (x, x2, kernel, bias, p, q))
    return _HexConvLayer.apply(x, x2, kernel, bias, p, q, radius, dilation,
                               kind, groups, bool(relu), save_pre)


def hex_conv_layer(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                   radius: int, dilation: int = 1, norm=None,
                   relu: bool = False) -> torch.Tensor:
    """One stride-1 'same' hex conv layer on NHWC ``x`` ``(B, H, W, Cin)``
    with flat hex weights ``kernel`` ``(Cout, Cin, kn)``, then ``bias``, an
    optional ``norm`` (``("gn", G, gamma, beta)`` or ``("affine", scale,
    shift)``) and an optional ReLU.  Returns ``(B, H, W, Cout)`` in x's
    dtype, differentiable in x, kernel, bias and the norm's vectors (gamma
    and beta, or scale and shift).

    A CPU tensor runs the plain versions (forward and backward).  A CUDA
    tensor (float32 or bfloat16, contiguous) launches the kernels (for
    bfloat16 on the tensor cores, with the kernel rounded to bf16);
    anything else raises.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hex_conv_layer: no kernel for device {x.device}")
    return _apply_layer(x, None, kernel, bias, radius, dilation, norm, relu)


def hex_conv_layer_split_plain(a: torch.Tensor, b: torch.Tensor,
                               kernel: torch.Tensor, bias=None, *,
                               radius: int, dilation: int = 1, norm=None,
                               relu: bool = False) -> torch.Tensor:
    """Plain version of :func:`hex_conv_layer_split`, on any device:
    :func:`hex_conv_layer_plain` on the materialised concatenation
    ``torch.cat([a, b], -1)``."""
    return hex_conv_layer_plain(torch.cat([a, b], dim=-1), kernel, bias,
                                radius=radius, dilation=dilation, norm=norm,
                                relu=relu)


def hex_conv_layer_split(a: torch.Tensor, b: torch.Tensor,
                         kernel: torch.Tensor, bias=None, *, radius: int,
                         dilation: int = 1, norm=None,
                         relu: bool = False) -> torch.Tensor:
    """The split layer: :func:`hex_conv_layer` on the channel concatenation
    of NHWC ``a`` ``(B, H, W, Ca)`` and ``b`` ``(B, H, W, Cb)``, without
    building it.  ``kernel`` is the unsplit ``(Cout, Ca + Cb, kn)``; bias,
    norm and ReLU as for :func:`hex_conv_layer`.  Returns ``(B, H, W,
    Cout)`` in the inputs' dtype, differentiable in a, b, kernel, bias and
    the norm's vectors.

    A CPU tensor runs the plain versions (forward and backward, as
    :func:`hex_conv_layer_split_plain` on the concatenation).  A CUDA
    tensor (float32 or bfloat16, contiguous, both inputs alike) launches
    the split mode of ``csrc/hex_conv_layer.cu`` (counted as
    ``"hex_conv_layer_split"``), and its backward the split dgrad and wgrad
    kernels; anything else raises.
    """
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hex_conv_layer_split: no kernel for device "
                         f"{a.device}")
    return _apply_layer(a, b, kernel, bias, radius, dilation, norm, relu)


def _dgrad_launch(gpre, kernel, radius, dilation, what):
    """One adjoint conv pass on checked NHWC ``gpre`` with the kernel
    ``(Cout, Cin, kn)`` transposed to ``(kn, Cout, Cin)``."""
    wt = kernel.detach().permute(2, 0, 1)                   # (kn, Cout, Cin)
    dx = _conv_launch(gpre, wt, kernel.shape[1], (radius, dilation, True),
                      what)[0]
    return dx


def hex_conv_layer_dgrad(gpre: torch.Tensor, kernel: torch.Tensor, *,
                         radius: int, dilation: int = 1) -> torch.Tensor:
    """dL/dx of one layer's conv, ``(B, H, W, Cin)`` in ``gpre``'s dtype,
    for the pre-activation cotangent ``gpre`` ``(B, H, W, Cout)``.

    On CUDA it is the conv pass of ``csrc/hex_conv_layer.cu`` run with the
    adjoint tap table and the weights transposed to ``(kn, Cout, Cin)``.
    A CPU tensor runs :func:`hex_conv_layer_dgrad_plain`.
    """
    if gpre.device.type == "cpu":
        return hex_conv_layer_dgrad_plain(gpre, kernel, radius=radius,
                                          dilation=dilation)
    if gpre.device.type != "cuda":
        raise ValueError(f"hex_conv_layer_dgrad: no kernel for device "
                         f"{gpre.device}")
    _check_activations(gpre, "hex_conv_layer_dgrad")
    cout, cin = gpre.shape[-1], kernel.shape[1]
    _check_kernel(kernel, (cout, cin, F.hex_kernel_num(radius)), gpre.device,
                  "hex_conv_layer_dgrad")
    dx = _dgrad_launch(gpre, kernel, radius, dilation, "hex_conv_layer_dgrad")
    count("hex_conv_layer_dgrad")
    return dx


def hex_conv_layer_split_dgrad(gpre: torch.Tensor, kernel: torch.Tensor,
                               ca: int, *, radius: int, dilation: int = 1):
    """dL/dA and dL/dB of the split layer's conv, ``(B, H, W, ca)`` and
    ``(B, H, W, Cin - ca)`` in ``gpre``'s dtype, for the pre-activation
    cotangent ``gpre`` ``(B, H, W, Cout)`` and the unsplit kernel ``(Cout,
    Cin, kn)``.

    On CUDA it is :func:`hex_conv_layer_dgrad`'s pass launched on
    ``kernel[:, :ca]`` and on ``kernel[:, ca:]`` (each launch counted as
    ``"hex_conv_layer_split_dgrad"``).  An output channel's sum does not depend on
    the other output channels, so the pair is bit-equal to the unsplit
    dgrad cut at ``ca``.  A CPU tensor runs
    :func:`hex_conv_layer_split_dgrad_plain`.
    """
    if gpre.device.type == "cpu":
        return hex_conv_layer_split_dgrad_plain(gpre, kernel, ca,
                                                radius=radius,
                                                dilation=dilation)
    if gpre.device.type != "cuda":
        raise ValueError(f"hex_conv_layer_split_dgrad: no kernel for device "
                         f"{gpre.device}")
    what = "hex_conv_layer_split_dgrad"
    _check_activations(gpre, what)
    cout, cin = gpre.shape[-1], kernel.shape[1]
    _check_kernel(kernel, (cout, cin, F.hex_kernel_num(radius)), gpre.device,
                  what)
    if not 0 < ca < cin:
        raise ValueError(f"{what}: the split must be 0 < ca < {cin}, got {ca}")
    out = []
    for part in (kernel[:, :ca], kernel[:, ca:]):
        out.append(_dgrad_launch(gpre, part, radius, dilation, what))
        count(what)
    return tuple(out)


def _wgrad_tile(dtype: torch.dtype, cin: int, cout: int, kn: int
                ) -> tuple[int, int, int]:
    """``(input channels, output channels, taps)`` one block of the dW
    partial pass covers, as the C entry chooses it: float32, CIB = 8, 16
    or 32 input channels from Cin, COB = 32 or 64 output channels from
    Cout and a warp a tap, kn in ``ceil(kn / 8)`` groups as even as they
    go (all 7 at radius 2; ``hex_conv_wgrad.cu::wgrad_f32_taps``; where
    their patch does not fit, :func:`_wgrad_f32_plan` takes fewer a block,
    and the chunks stay these taps'); bfloat16, N = 8, 16 or 32 input channels from Cin, 64 output channels
    (wgmma's M) and 7 taps, one for a one-tap kernel
    (``hex_conv_wgrad.cu::wgrad_mma_n``, ``launch_wgrad_bf16``)."""
    ci = 8 if cin <= 8 else 16 if cin <= 16 else 32
    if dtype != torch.bfloat16:
        groups = -(-kn // _WGRAD_F32_TAPS)
        return ci, 32 if cout <= 32 else 64, -(-kn // groups)
    return ci, 64, 1 if kn == 1 else 7


def _wgrad_f32_plan(cin: int, cout: int, tap_rows, n_cols: int) -> dict:
    """The float32 dW partial pass's block for these shapes, as
    ``hex_conv_wgrad.cu`` lays it out (``wgrad_f32_plan``; the C entry
    refuses a launch whose plan differs): ``cib``, ``cob``, ``taps`` (a
    warp each: ``threads``; :func:`_wgrad_tile`'s, fewer where the patch
    their rows reach does not fit), the warp's channel lanes and pixel
    slices ``ps`` (a thread holds 8 x 8), the staged pixel strides ``sx`` /
    ``sg`` of x and g in floats, ``kp`` pixels a step (128 where cib = 8,
    else 64), ``stages`` (two where they fit in a block's shared memory)
    and ``smem`` bytes, for taps reaching ``tap_rows`` (:func:`_tap_rows`)
    and a patch of ``n_cols`` (64 + tap width) columns around 64 pixels;
    None where one stage of one tap does not fit."""
    cib, cob, most = _wgrad_tile(torch.float32, cin, cout, len(tap_rows))
    lanes = (cib // 8) * (cob // 8)
    ps = 32 // lanes
    sx = cib * 3 // 2 if ps > 1 else cib
    sg = 48 if cob == 32 else cob
    kp = 128 if cib == 8 else 64
    for taps in range(most, 0, -1):
        band = _band_rows(tap_rows, taps)
        for stages in (2, 1):
            smem = 4 * stages * (kp * sg + band * (n_cols - 64 + kp) * sx)
            if smem <= _MMA_MAX_SMEM:
                return dict(cib=cib, cob=cob, taps=taps, threads=32 * taps,
                            lanes=lanes, ps=ps, sx=sx, sg=sg, kp=kp,
                            stages=stages, smem=smem)
    return None


def _wgrad_chunks(dtype: torch.dtype, rows: int, cin: int, cout: int,
                  kn: int) -> tuple[int, int]:
    """``(rows_per_chunk, n_chunks)`` of the dW partial pass over ``rows``
    image rows (B x H): as many chunks as bring the blocks (chunks x
    channel tiles x tap groups) to ``_WGRAD_BLOCKS``, at least one row a
    chunk, the rows spread evenly, from the shapes alone (so every card
    folds the same partial sums).  The partial scratch is ``(n_chunks,
    kn, Cin, Cout)`` float32."""
    ci, co, taps = _wgrad_tile(dtype, cin, cout, kn)
    tiles = -(-cin // ci) * -(-cout // co) * -(-kn // taps)
    n_chunks = max(1, min(rows, -(-_WGRAD_BLOCKS // tiles)))
    rows_per_chunk = -(-rows // n_chunks)
    return rows_per_chunk, -(-rows // rows_per_chunk)


def _wgrad_launch(x, gpre, radius, dilation, what):
    """One ``hg_hex_conv_wgrad`` run on checked NHWC ``x`` and ``gpre``."""
    b, h, w, cin = x.shape
    cout = gpre.shape[-1]
    kn = F.hex_kernel_num(radius)
    rows_per_chunk, n_chunks = _wgrad_chunks(x.dtype, b * h, cin, cout, kn)
    fields = None
    if x.dtype == torch.float32:
        plan = _wgrad_f32_plan(cin, cout, _tap_rows(radius, dilation, False),
                               _patch_shape(radius, dilation, False)[1])
        if plan is None:
            raise ValueError(f"{what}: no float32 dW block of {kn} taps "
                             f"fits in shared memory")
        fields = (ctypes.c_int * 5)(plan["cib"], plan["cob"], plan["taps"],
                                    plan["stages"], plan["smem"])
    partial = torch.empty((n_chunks, kn, cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((cout, cin, kn), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_hex_conv_wgrad(
            x.data_ptr(), gpre.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            _DTYPES[x.dtype], b, h, w, cin, cout, kn,
            _taps(radius, dilation).ctypes.data, rows_per_chunk, n_chunks,
            fields, stream)
    _build.check(status, what)
    return dw


def hex_conv_layer_wgrad(x: torch.Tensor, gpre: torch.Tensor, *,
                         radius: int, dilation: int = 1) -> torch.Tensor:
    """dL/dW of one layer's conv, float32 ``(Cout, Cin, kn)``, from its input
    ``x`` ``(B, H, W, Cin)`` and pre-activation cotangent ``gpre``
    ``(B, H, W, Cout)`` of the same dtype.

    On CUDA it runs ``csrc/hex_conv_wgrad.cu`` (per-chunk partial sums,
    on the tensor cores in bfloat16, then a fold in chunk order:
    deterministic).  A CPU tensor runs :func:`hex_conv_layer_wgrad_plain`.
    """
    if x.device.type == "cpu":
        return hex_conv_layer_wgrad_plain(x, gpre, radius=radius,
                                          dilation=dilation)
    if x.device.type != "cuda":
        raise ValueError(f"hex_conv_layer_wgrad: no kernel for device "
                         f"{x.device}")
    _check_pair(x, gpre, "hex_conv_layer_wgrad")
    dw = _wgrad_launch(x, gpre, radius, dilation, "hex_conv_layer_wgrad")
    count("hex_conv_layer_wgrad")
    return dw


def hex_conv_layer_split_wgrad(a: torch.Tensor, b: torch.Tensor,
                               gpre: torch.Tensor, *, radius: int,
                               dilation: int = 1) -> torch.Tensor:
    """dL/dW of the split layer's conv, float32 ``(Cout, Ca + Cb, kn)``
    (the unsplit kernel's), from its inputs ``a`` ``(B, H, W, Ca)`` and
    ``b`` ``(B, H, W, Cb)`` and the pre-activation cotangent ``gpre``
    ``(B, H, W, Cout)``, all of one dtype.

    On CUDA it runs :func:`hex_conv_layer_wgrad`'s kernel on ``a`` and on
    ``b`` (each run counted as ``"hex_conv_layer_split_wgrad"``; a run is
    two CUDA launches) and concatenates
    the two along Cin, as the reference does.  A CPU tensor runs
    :func:`hex_conv_layer_split_wgrad_plain`.
    """
    if a.device.type == "cpu":
        return hex_conv_layer_split_wgrad_plain(a, b, gpre, radius=radius,
                                                dilation=dilation)
    if a.device.type != "cuda":
        raise ValueError(f"hex_conv_layer_split_wgrad: no kernel for device "
                         f"{a.device}")
    what = "hex_conv_layer_split_wgrad"
    _check_pair(a, b, what)
    _check_pair(a, gpre, what)
    out = []
    for x in (a, b):
        out.append(_wgrad_launch(x, gpre, radius, dilation, what))
        count(what)
    return torch.cat(out, dim=1)


def hex_conv_fused_stack_plain(x: torch.Tensor, kernels, biases, *,
                               radius: int, dilation: int = 1, relus
                               ) -> torch.Tensor:
    """Plain version of :func:`hex_conv_fused_stack`: chained
    :func:`hex_conv_layer_plain`, each layer rounded to x's dtype, as the
    kernel rounds its activations between layers."""
    for k, b, relu in zip(kernels, biases, relus):
        x = hex_conv_layer_plain(x, k, b, radius=radius, dilation=dilation,
                                 relu=relu)
    return x


def _fused_launch(x, kernels, biases, radius, dilation, relus):
    """One ``hg_hex_conv_fused_stack`` call on checked NHWC ``x``, counted
    as ``"hex_conv_fused_stack"``."""
    _check_activations(x, "hex_conv_fused_stack")
    b, h, w, c = x.shape
    n = len(kernels)
    kn = F.hex_kernel_num(radius)
    if not 2 <= n <= _FUSED_MAX_LAYERS:
        raise ValueError(f"hex_conv_fused_stack: 2 to {_FUSED_MAX_LAYERS} "
                         f"layers, got {n}")
    for k in kernels:
        _check_kernel(k, (c, c, kn), x.device, "hex_conv_fused_stack")
    w_all = _fused_weights(kernels, x.dtype)
    bias_bits = sum(1 << i for i, bs in enumerate(biases) if bs is not None)
    bias_all = None
    if bias_bits:
        bias_all = torch.stack([
            torch.zeros(c, device=x.device) if bs is None
            else _check_param(bs.detach(), "bias", c, x.device)
            for bs in biases]).contiguous()                 # (L, C)
    relu_bits = sum(1 << i for i, r in enumerate(relus) if r)
    group = max(1, min(b, _FUSED_GROUP_BYTES // (h * w * c * x.element_size())))
    out = torch.empty_like(x)
    bufs = [torch.empty((group, h, w, c), dtype=x.dtype, device=x.device)
            for _ in range(2)]
    plan = np.zeros(7, np.int32)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_hex_conv_fused_stack(
            x.data_ptr(), out.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), w_all.data_ptr(),
            _ptr(bias_all), bias_bits, relu_bits, _DTYPES[x.dtype], n, b,
            group, h, w, c, kn, _taps(radius, dilation).ctypes.data,
            plan.ctypes.data, stream)
    _build.check(status, "hex_conv_fused_stack")
    count("hex_conv_fused_stack")
    LAST_FUSED_PLAN.clear()
    LAST_FUSED_PLAN.update(zip(
        ("n", "rows", "threads", "weights", "smem", "grid", "blocks_per_sm"),
        plan.tolist()))
    LAST_FUSED_PLAN.update(weights=_FUSED_WEIGHTS[plan[3]], group=group)
    return out


def _fused_cpu(x, kernels, biases, radius, dilation, relus):
    return hex_conv_fused_stack_plain(x, kernels, biases, radius=radius,
                                      dilation=dilation, relus=relus)


_FUSED_OP = _ops.define(
    "hex_conv_fused_stack(Tensor x, Tensor[] kernels, Tensor?[] biases, "
    "int radius, int dilation, bool[] relus) -> Tensor",
    cpu=_fused_cpu, cuda=_fused_launch,
    fake=lambda x, kernels, biases, radius, dilation, relus: x.new_empty(
        x.shape))


class _HexConvFusedStack(torch.autograd.Function):
    """The fused stack (the op ``hygrid::hex_conv_fused_stack``); its
    backward recomputes the stack through chained :func:`hex_conv_layer`
    calls and pulls the cotangent back
    through them (``conv_pallas.py:1338-1362`` recomputes through
    ``_stack_xla``)."""

    @staticmethod
    def forward(ctx, x, radius, dilation, relus, n, *params):
        kernels, biases = params[:n], params[n:]
        ctx.geometry = (radius, dilation, relus, n)
        ctx.save_for_backward(x, *kernels,
                              *[bs for bs in biases if bs is not None])
        ctx.has_bias = [bs is not None for bs in biases]
        return _FUSED_OP(x, list(kernels), list(biases), radius,
                         dilation, list(relus))

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        radius, dilation, relus, n = ctx.geometry
        saved = ctx.saved_tensors
        x, kernels, rest = saved[0], saved[1:n + 1], list(saved[n + 1:])
        biases = [rest.pop(0) if has else None for has in ctx.has_bias]
        with torch.enable_grad():
            xs = x.detach().requires_grad_(ctx.needs_input_grad[0])
            ks = [k.detach().requires_grad_() for k in kernels]
            bs = [None if b is None else b.detach().requires_grad_()
                  for b in biases]
            h = xs
            for k, b, relu in zip(ks, bs, relus):
                h = hex_conv_layer(h, k, b, radius=radius, dilation=dilation,
                                   relu=relu)
            leaves = [t for t in (xs, *ks, *bs)
                      if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(h, leaves, gout))
        dx = next(grads) if xs.requires_grad else None
        dks = [next(grads) for _ in ks]
        dbs = [None if b is None else next(grads) for b in bs]
        return (dx, None, None, None, None, *dks, *dbs)


def hex_conv_fused_stack(x: torch.Tensor, kernels, biases=None, *,
                         radius: int, dilation: int = 1, relus
                         ) -> torch.Tensor:
    """A uniform-width, norm-free stack of stride-1 'same' hex conv layers
    on NHWC ``x`` ``(B, H, W, C)``: layer i is the conv with ``kernels[i]``
    ``(C, C, kn)``, plus ``biases[i]`` ``(C,)`` if not None, then ReLU where
    ``relus[i]``.  Returns ``(B, H, W, C)`` in x's dtype, differentiable in
    x, the kernels and the biases.

    A CPU tensor runs :func:`hex_conv_fused_stack_plain`.  A CUDA tensor
    (float32 or bfloat16, contiguous, 2 to 64 layers) runs the whole stack
    in one cooperative launch of ``csrc/hex_conv_fused_stack.cu``, bit-equal
    to chained :func:`hex_conv_layer` launches (kernel B's tensor-core sums
    on bands of output rows in bfloat16, its CUDA-core tile in float32); a
    device that cannot run the launch raises ``RuntimeError``.  Anything
    else raises.
    """
    kernels = list(kernels)
    biases = [None] * len(kernels) if biases is None else list(biases)
    relus = tuple(bool(r) for r in relus)
    if not len(kernels) == len(biases) == len(relus):
        raise ValueError(f"hex_conv_fused_stack: {len(kernels)} kernels, "
                         f"{len(biases)} biases and {len(relus)} relus")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hex_conv_fused_stack: no kernel for device "
                         f"{x.device}")
    return _HexConvFusedStack.apply(x, radius, dilation, relus, len(kernels),
                                    *kernels, *biases)


def _same_margin_feasible(radius: int, dilation: int, q: int) -> bool:
    """``conv_pallas._same_meta_feasible``: whether the folded 'same'
    padding ``d*(r-1)`` stays inside the TPU's packed plane margin (one row
    and one packed column at the top and left) at packing ``q``.  Kept only
    for the reference's ``band_rows`` argument check."""
    d = dilation
    p = d * (radius - 1)
    parity = p % 2
    for (i, t, ln, _) in F._hex_kernel_rows(radius):
        c0 = ((1 + t * d - ((i * d + parity) % 2)) // 2,
              (2 + t * d - ((1 + i * d + parity) % 2)) // 2)
        for row_base in (0, 1):
            if (row_base + i * d - p) // 2 + 1 < 0:
                return False
            # the leftmost packed column is read by output lane 0, tap 0
            if (c0[row_base] - p) // q + 1 < 0:
                return False
    return True


def _split_norms(norms, kernels):
    """Validate the per-layer ``norms`` list (``conv_pallas._split_norms``)
    and return one normalised entry per layer."""
    if norms is None:
        return [None] * len(kernels)
    if len(norms) != len(kernels):
        raise ValueError(f"norms has {len(norms)} entries for "
                         f"{len(kernels)} layers")
    out = []
    for i, (n, k) in enumerate(zip(norms, kernels)):
        if n is None:
            out.append(None)
        elif n[0] == "gn":
            _, g, gamma, beta = n
            if int(k.shape[0]) % int(g):
                raise ValueError(f"layer {i}: {g} groups do not divide "
                                 f"{int(k.shape[0])} channels")
            out.append(("gn", int(g), gamma, beta))
        elif n[0] == "affine":
            _, scale, shift = n
            out.append(("affine", scale, shift))
        else:
            raise ValueError(f"unknown norm spec {n!r}")
    return out


def hex_conv_stack(x: torch.Tensor, kernels, biases=None, *, radius: int,
                   even_odd_offset: int = 0, dilation: int = 1,
                   activation="relu", final_activation: bool = True,
                   norms=None, data_format: str = "NCHW",
                   fused: bool = False, band_rows=None,
                   packed_io: bool = False, extra_input=None,
                   plain: bool = False) -> torch.Tensor:
    """A chain of 'same' hex convolutions, one :func:`hex_conv_layer` each.

    Equal to chaining ``act(norm(hex_conv2d(x, k, b, padding=d*(r-1))))``;
    the trailing activation is skipped when ``final_activation`` is False.
    ``norms`` has one entry per layer: None, ``("gn", G, gamma, beta)`` or
    ``("affine", scale, shift)``.  ``data_format`` is "NCHW" or "NHWC" for
    both input and output (layers run NHWC).  ``fused=True`` runs a
    uniform-width stack of two or more layers as one
    :func:`hex_conv_fused_stack` launch and chains other stacks, as the
    reference does; ``band_rows`` computes the same function as without it.
    Both raise the reference's ``ValueError`` with norms, and together.
    ``plain=True`` runs the plain versions on any device (the reference a
    kernel run is compared with).

    ``extra_input``, a second input with ``x``'s batch and spatial shape,
    applies the chain to the channel concatenation ``concat([x,
    extra_input])`` (``kernels[0]`` takes both inputs' channels) without
    building it: layer 0 is :func:`hex_conv_layer_split`, for any split of
    the channels, differentiable in both inputs.  It is incompatible with
    ``packed_io``,
    ``fused`` and ``band_rows``, as in the reference.
    """
    split = extra_input is not None
    if split and (packed_io or fused or band_rows is not None):
        raise ValueError("extra_input is incompatible with packed_io/"
                         "fused/band_rows")
    if packed_io:
        raise NotImplementedError(
            "hex_conv_stack: packed_io is not ported (the TPU's packed-plane "
            "layout; ROADMAP, not to port)")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    if even_odd_offset != 0:
        raise ValueError("the stack assumes offset-0 input (the output "
                         "convention of every op in this framework)")
    if activation not in ("relu", None, "none"):
        raise ValueError("supported fused activations: 'relu' or None")
    while x.ndim < 4:
        x = x[None]
    if split:
        x2 = extra_input
        while x2.ndim < 4:
            x2 = x2[None]
        sp = slice(1, 3) if data_format == "NHWC" else slice(2, 4)
        if x2.shape[0] != x.shape[0] or x2.shape[sp] != x.shape[sp]:
            raise ValueError(
                f"extra_input batch/spatial shape {tuple(x2.shape)} does not "
                f"match x {tuple(x.shape)}")
    kernels = list(kernels)
    biases = [None] * len(kernels) if biases is None else list(biases)
    norms = _split_norms(norms, kernels)
    has_norm = any(nm is not None for nm in norms)
    if fused and has_norm:
        raise ValueError("norms are not supported with fused=True")
    if band_rows is not None:
        if has_norm:
            raise ValueError(
                "band_rows is incompatible with norms: GroupNorm needs "
                "whole-image statistics, a band sees only its rows")
        if fused:
            raise ValueError("band_rows is incompatible with fused=True")
        cb = int(x.shape[-1] if data_format == "NHWC" else x.shape[1])
        if cb <= 128 and 128 % cb == 0 and not _same_margin_feasible(
                radius, dilation, 128 // cb):
            raise ValueError(
                f"banded stack does not support radius={radius}, "
                f"dilation={dilation} (the 'same' padding exceeds the "
                f"banded plane margin)")
    def nhwc(t):
        return (t.permute(0, 2, 3, 1) if data_format == "NCHW" else t
                ).contiguous()

    h = nhwc(x)
    n = len(kernels)
    relus = [activation == "relu" and (final_activation or i < n - 1)
             for i in range(n)]
    chans = {h.shape[-1]} | {int(k.shape[0]) for k in kernels}
    if fused and len(chans) == 1 and n >= 2 and not plain:
        h = hex_conv_fused_stack(h, kernels, biases, radius=radius,
                                 dilation=dilation, relus=relus)
    else:
        layer = hex_conv_layer_plain if plain else hex_conv_layer
        for i, (k, bs, nm, relu) in enumerate(zip(kernels, biases, norms,
                                                  relus)):
            kw = dict(radius=radius, dilation=dilation, norm=nm, relu=relu)
            if split and i == 0:
                h = (hex_conv_layer_split_plain if plain
                     else hex_conv_layer_split)(h, nhwc(x2), k, bs, **kw)
            else:
                h = layer(h, k, bs, **kw)
    return h.permute(0, 3, 1, 2) if data_format == "NCHW" else h
