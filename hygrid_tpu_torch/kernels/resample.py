"""Kernel A: the plan-gather resampler (``csrc/plan_gather.cu``).

Port of ``hygrid_tpu/kernels/resample_pallas.py`` (``_resample_kernel`` and
its banded, phased and phased-banded variants):
``out[n, p] = sum_k w[k, p] * src[n, idx[k, p]]`` over the B*C planes of
``(..., H, W)`` and the plan's ``h1*w1`` output pixels.  The plain version
is :func:`hygrid_tpu_torch.ops.sampling.apply_plan`.

Both keep the plan weights in float32 and accumulate in float32, also for
bf16 images, and round once to the image dtype; the kernel sums the taps
as an ``fmaf`` chain in the plan's k order.  This differs on purpose from
``hygrid_tpu``, whose TPU kernel ships bf16 weights for bf16 images and
whose XLA ``apply_plan`` accumulates bf16 in bf16.

The kernel reads the plan from the tables of :func:`gather_tables`, built
once per plan and element size from the plan's structure alone, each
lossless (:meth:`GatherTables.expand` gives back ``plan.idx`` and
``plan.weights`` bit for bit):

* a **row-band** plan (:func:`rowsep_decompose`, and every tap, zero
  weights included, on source row ``rowbase[r]`` or ``rowbase[r] + 1``)
  is run in tiles of 8 output rows by one warp's 32 x V columns, each
  tile's source band staged in shared memory plane by plane.  Its indices
  are ``rowbase`` and, per tap, the row part d and the column relative
  to the tile's band: ``"parity"`` where d depends on the row alone and
  the columns on the row's parity (int16 ``(K, 2, w1)`` and uint8
  ``(K, h1)``: the rect->hex and same-size plans), else ``"rows"`` (one
  int16 ``col << 1 | d`` a tap and pixel);
* any other plan keeps the ``"dense"`` int32 indices and gathers from
  global memory.

Weights are ``"factored"`` for a rect->hex bilinear plan whose recorded
float64 factors (``ops/sampling.py::_rect_factors``) rebuild
``plan.weights`` bit for bit: the kernel forms ``float32((col * row) *
valid)`` in float64 as ``rect_sample_plan`` does.  Every other plan ships
its float32 weights a pixel (``"pixel"``).

:func:`plan_gather` calls the op ``hygrid::plan_gather`` (``_ops.py``) on
the tables' tensors and their geometry, so that an exported program keeps
the launch as one node and the tables as its constants.  Its CPU
implementation expands the tables to the dense plan (:func:`dense_plan`)
and runs :func:`apply_plan`'s gather-blend on it, bit-equal to
:func:`apply_plan`; its CUDA implementation launches the kernel.
:func:`plan_gather` is differentiable on both devices: its backward is
the transpose scatter :func:`plan_gather_vjp_plain` (an f32 ``index_add_``),
the counterpart of ``resample_pallas._apply_plan_pallas_bwd`` (an XLA
``segment_sum``, not a Pallas kernel, in ``hygrid_tpu``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..ops.sampling import SamplePlan, gather_blend
from ..utils.profiling import count, span
from . import _build, _ops

__all__ = ["plan_gather", "plan_gather_vjp_plain", "rowsep_decompose",
           "rowsep_decompose_cached", "GatherTables", "gather_tables",
           "gather_tables_cached", "dense_plan", "last_launch"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 8
# the kernel's tile, as csrc/plan_gather.cu fixes it: 8 warps, one output
# row each, a warp 32 lanes x V = 16 bytes / element size columns
TILE_ROWS = 8
_INDEX_FORMS = {"dense": 0, "rows": 1, "parity": 2}
_WEIGHT_FORMS = {"pixel": 0, "factored": 1}
# the shared memory a block may take (H100: 227 KB); the source bands a
# block keeps in flight, a ring (csrc/plan_gather.cu's kStages)
_SMEM_BYTES = 227 * 1024
STAGES = 4


def tile_width(esz: int) -> int:
    """Output columns of one tile (one warp's 32 lanes x V outputs, V
    16-byte vectors' worth) for ``esz``-byte elements."""
    return 32 * (16 // esz)


def rowsep_decompose(plan: SamplePlan):
    """Decompose a plan into the row-band form (numpy copy of
    ``hygrid_tpu.kernels.resample_pallas.rowsep_decompose``).

    Returns ``(rowbase (h1,) int32, cols (2, K, h1, w1) int32,
    wts (2, K, h1, w1) float32)`` such that::

        out[c, r, :] = sum_d sum_k wts[d,k,r,:] * src[c, rowbase[r]+d, cols[d,k,r,:]]

    or None if the plan is not row-separable.
    """
    h, w = plan.src_shape
    if h < 2:
        return None
    k, h1, w1 = plan.idx.shape
    rows = plan.idx // w
    cols = plan.idx % w
    valid = plan.weights != 0
    base = _row_base(rows, valid, h).astype(np.int64)
    delta = rows - base[None, :, None]
    if np.any(valid & ((delta < 0) | (delta > 1))):
        return None
    # keep only slots that carry any weight for the given row-part
    per_d = []
    for d in (0, 1):
        sel = valid & (delta == d)
        c_list, w_list = [], []
        for kk in range(k):
            wk = np.where(sel[kk], plan.weights[kk], 0.0)
            if np.any(wk):
                c_list.append(np.where(sel[kk], cols[kk], 0))
                w_list.append(wk)
        per_d.append((c_list, w_list))
    kd = max(1, max(len(c) for c, _ in per_d))
    out_cols = np.zeros((2, kd, h1, w1), np.int32)
    out_wts = np.zeros((2, kd, h1, w1), np.float32)
    for d in (0, 1):
        c_list, w_list = per_d[d]
        for i, (c, wv) in enumerate(zip(c_list, w_list)):
            out_cols[d, i] = c
            out_wts[d, i] = wv
    return base.astype(np.int32), out_cols, out_wts


def _row_base(rows: np.ndarray, valid: np.ndarray, h: int) -> np.ndarray:
    """:func:`rowsep_decompose`'s first source row of each output row,
    ``(h1,)`` int32 in ``[0, h - 2]``, from the taps' source ``rows`` ``(K,
    h1, w1)`` and where their weights are non-zero (``valid``)."""
    # zero-weight entries are clamped placeholders: they can live anywhere
    big = np.where(valid, rows, h + 10)
    base = big.min(axis=(0, 2))                      # (h1,)
    invalid = base > h                               # fully-invalid rows:
    if invalid.all():
        base = np.zeros_like(base)
    elif invalid.any():
        # forward/backward-fill from valid neighbours (any in-range value
        # is correct: these rows carry only zero weights)
        idxs = np.arange(base.shape[0])
        ffill = np.maximum.accumulate(np.where(~invalid, idxs, -1))
        rev = np.where(~invalid[::-1], idxs[::-1], 2 * base.shape[0])
        bfill = np.minimum.accumulate(rev)[::-1]
        base = base[np.where(ffill >= 0, ffill, bfill)]
    return np.clip(base, 0, h - 2).astype(np.int32)


def rowsep_decompose_cached(plan: SamplePlan):
    """:func:`rowsep_decompose`, computed once per plan and kept on it
    (``plan._derived``), as the shift resampler's decomposition is."""
    if "rowsep" not in plan._derived:
        plan._derived["rowsep"] = rowsep_decompose(plan)
    return plan._derived["rowsep"]


@dataclasses.dataclass(frozen=True)
class GatherTables:
    """The plan-gather kernel's tables for one plan and element size.

    ``index_form`` ("dense", "rows" or "parity") and ``weight_form``
    ("pixel" or "factored") as the module note describes.  Row-band forms
    carry the tile geometry: ``rowbase (h1,)``, each row tile's first band
    row ``tile_row_lo (n_rtiles,)`` and each tile's first band column
    ``tile_col_lo (n_rtiles, n_ctiles)`` (a multiple of 16 bytes), and the
    band's extent ``band_rows`` x ``band_pitch`` elements.  ``idx``:
    int32 ``(K, h1*w1)`` (dense), int16 ``(K, h1*w1)`` holding ``col << 1
    | d`` (rows), int16 ``(K, 2, w1p)`` columns by row parity (parity,
    with ``dk`` uint8 ``(K, h1)``); ``weights``: float32 ``(K, h1*w1)``, or
    float64 ``rowf (h1, 4)`` and ``colf (2, 4, w1p)`` (factored: the row
    factors for a = 0, 1 and their validities; by row parity the column
    factors for b = 0, 1 and their validities).  ``w1p`` is ``w1`` padded
    to whole column tiles, zeros past ``w1``, so that a tile's slice is
    whole 16-byte units for the kernel's bulk copies."""
    index_form: str
    weight_form: str
    esz: int
    shape: tuple                  # (K, h1, w1, H, W)
    idx: np.ndarray
    weights: np.ndarray = None
    rowf: np.ndarray = None
    colf: np.ndarray = None
    dk: np.ndarray = None
    rowbase: np.ndarray = None
    tile_row_lo: np.ndarray = None
    tile_col_lo: np.ndarray = None
    band_rows: int = 0
    band_pitch: int = 0
    _device_copies: Dict[str, dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def arrays(self) -> dict:
        """The arrays the kernel reads, by name (None where unused)."""
        return dict(idx=self.idx, dk=self.dk, weights=self.weights,
                    rowf=self.rowf, colf=self.colf, rowbase=self.rowbase,
                    tile_row_lo=self.tile_row_lo,
                    tile_col_lo=self.tile_col_lo)

    @property
    def table_bytes(self) -> int:
        """Bytes of the tables the kernel reads."""
        return sum(a.nbytes for a in self.arrays.values() if a is not None)

    def tensors(self, device) -> dict:
        """The arrays of :attr:`arrays` as tensors on ``device`` (None where
        unused), uploaded once per table and device."""
        key = str(torch.device(device))
        tabs = self._device_copies.get(key)
        if tabs is None:
            tabs = {name: None if a is None else
                    torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for name, a in self.arrays.items()}
            self._device_copies[key] = tabs
        return tabs

    def expand(self):
        """``(idx (K, h1, w1) int32, weights (K, h1, w1) float32)``: the
        dense plan these tables encode, in numpy, as the kernel reads it
        (bit-equal to ``plan.idx`` and ``plan.weights``; :func:`dense_plan`
        on the tables)."""
        k, h1, w1, _, w = self.shape
        tabs = {n: None if a is None else torch.from_numpy(a)
                for n, a in self.arrays.items()}
        del tabs["tile_row_lo"]
        idx, weights = dense_plan(**tabs, w=w, h1=h1, w1=w1, esz=self.esz,
                                  index_form=self.index_form,
                                  weight_form=self.weight_form)
        return (idx.reshape(k, h1, w1).int().numpy(),
                weights.reshape(k, h1, w1).numpy())


class _TableArgs(ctypes.Structure):
    """csrc/plan_gather.cu's ``TableArgs``: the tables' device pointers (by
    the names of :attr:`GatherTables.arrays`) and their geometry."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "dk", "weights", "rowf", "colf", "rowbase", "tile_row_lo",
        "tile_col_lo")] + [(n, ctypes.c_int) for n in (
            "h", "w", "h1", "w1", "w1p", "k", "index_form", "weight_form",
            "band_rows", "band_pitch", "tile_w")]


def _smem_bytes(esz, k, index_form, weight_form, band_rows, band_pitch):
    """A block's dynamic shared memory: the 8 warps' output staging (16
    bytes a lane) and, for row-band forms, the ring of ``STAGES`` bands,
    the tile's table slice (parity: its int16 columns; factored: its
    float64 column factors) and the table's 8-byte mbarrier."""
    seg = tile_width(esz)
    if index_form == "dense":
        return TILE_ROWS * seg * esz
    return (STAGES * band_rows * band_pitch * esz + TILE_ROWS * seg * esz
            + (k * 2 * seg * 2 if index_form == "parity" else 0)
            + (8 * seg * 8 if weight_form == "factored" else 0) + 8)


def _factored_weights(rowf: torch.Tensor, colf: torch.Tensor,
                      w1: int) -> torch.Tensor:
    """float32 ``(4, h1, w1)`` weights of a factored table (``colf`` with
    at least ``w1`` columns): tap ``k = 2a + b`` is ``(col_b * row_a) *
    (valid_row_a * valid_col_b)`` in float64, rounded once, as the kernel
    forms it."""
    h1 = rowf.shape[0]
    cf = colf[torch.arange(h1, device=rowf.device) % 2][..., :w1]
    rf = rowf[:, :, None]                                # (h1, 4, 1)
    return torch.stack([((cf[:, b] * rf[:, a])
                         * (rf[:, 2 + a] * cf[:, 2 + b])).float()
                        for a in (0, 1) for b in (0, 1)])


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a, np.float32).view(np.uint32),
        np.ascontiguousarray(b, np.float32).view(np.uint32))


def _factored_table(plan: SamplePlan):
    """``(rowf, colf)`` from the plan's recorded factors where they rebuild
    ``plan.weights`` bit for bit, else None."""
    f = plan._derived.get("rect_factors")
    k, h1, w1 = plan.idx.shape
    if f is None or k != 4:
        return None
    rowf = np.concatenate([f["row"], f["row_valid"]], -1)    # (h1, 4)
    colf = np.concatenate([f["col"], f["col_valid"]], -1).transpose(0, 2, 1)
    if rowf.shape != (h1, 4) or colf.shape != (2, 4, w1):
        return None
    if not _bits_equal(_factored_weights(torch.from_numpy(rowf),
                                         torch.from_numpy(colf), w1).numpy(),
                       plan.weights):
        return None
    return (np.ascontiguousarray(rowf, np.float64),
            np.ascontiguousarray(colf, np.float64))


def gather_tables(plan: SamplePlan, esz: int,
                  factored: bool = True) -> GatherTables:
    """The kernel's tables for ``plan`` and ``esz``-byte images (see the
    module note); the form follows the plan's structure alone.
    ``factored=False`` keeps per-pixel weights where the factored form
    would apply (to compare the two on the card)."""
    k, h1, w1 = plan.idx.shape
    h, w = plan.src_shape
    shape = (k, h1, w1, h, w)
    flat = plan.weights.reshape(k, -1)
    dense = GatherTables("dense", "pixel", esz, shape,
                         idx=plan.idx.reshape(k, -1), weights=flat)
    if h < 2:
        return dense
    # every tap, zero weights included, on row base or base + 1: stricter
    # than rowsep_decompose, which places only the non-zero taps
    rows = plan.idx // w
    cols = plan.idx - rows * w
    base = _row_base(rows, plan.weights != 0, h)
    d = rows - base[None, :, None]
    if d.min() < 0 or d.max() > 1:
        return dense
    seg, ch = tile_width(esz), 16 // esz
    n_rt, n_ct = -(-h1 // TILE_ROWS), -(-w1 // seg)
    rb = np.pad(base, (0, n_rt * TILE_ROWS - h1), mode="edge").reshape(
        n_rt, TILE_ROWS)
    row_lo = rb.min(1)
    band_rows = int((rb.max(1) + 2 - row_lo).max())

    def tiles(a):     # (h1, w1) -> (n_rt, 8, n_ct, seg), edges repeated
        return np.pad(a, ((0, n_rt * TILE_ROWS - h1), (0, n_ct * seg - w1)),
                      mode="edge").reshape(n_rt, TILE_ROWS, n_ct, seg)

    cmin = tiles(cols.min(0)).min(axis=(1, 3))           # (n_rt, n_ct)
    cmax = tiles(cols.max(0)).max(axis=(1, 3))
    # d a function of the row, the columns of the row's parity
    parity = bool(np.array_equal(d[:, :, 1:], d[:, :, :-1])
                  and np.array_equal(cols[:, 2:], cols[:, :-2]))
    if parity:        # one band origin a column tile, whatever the row
        cmin = np.broadcast_to(cmin.min(0), cmin.shape)
        cmax = np.broadcast_to(cmax.max(0), cmax.shape)
    col_lo = (cmin // ch) * ch
    pitch = int(-(-(cmax - col_lo + 1).max() // ch) * ch)
    geo = dict(rowbase=base, tile_row_lo=row_lo.astype(np.int32),
               tile_col_lo=np.ascontiguousarray(col_lo, np.int32),
               band_rows=band_rows, band_pitch=pitch)
    w1p = n_ct * seg
    fac = _factored_table(plan) if parity and factored else None
    index_form = "parity" if parity else "rows"
    weight_form = "pixel" if fac is None else "factored"
    if pitch >= 2 ** 15 or _smem_bytes(
            esz, k if k <= 4 else _MAX_TAPS, index_form, weight_form,
            band_rows, pitch) > _SMEM_BYTES:
        return dense
    lo = col_lo[(np.arange(h1) // TILE_ROWS)[:, None],
                (np.arange(w1) // seg)[None, :]]         # (h1, w1)
    if parity:     # columns by row parity, padded to whole tiles
        two = [0, 1] if h1 > 1 else [0, 0]
        idx = np.zeros((k, 2, w1p), np.int16)
        idx[:, :, :w1] = cols[:, two] - lo[two][None]
        geo["dk"] = np.ascontiguousarray(d[:, :, 0], np.uint8)
    else:
        idx = (((cols - lo[None]) << 1) | d).astype(np.uint16).view(np.int16)
        idx = idx.reshape(k, -1)
    if fac is not None:
        colf = np.zeros((2, 4, w1p))
        colf[:, :, :w1] = fac[1]
        return GatherTables(index_form, weight_form, esz, shape, idx=idx,
                            rowf=fac[0], colf=colf, **geo)
    return GatherTables(index_form, weight_form, esz, shape, idx=idx,
                        weights=flat, **geo)


def gather_tables_cached(plan: SamplePlan, esz: int) -> GatherTables:
    """:func:`gather_tables`, built once per plan and element size and
    kept on the plan."""
    key = ("gather", esz)
    tables = plan._derived.get(key)
    if tables is None:
        tables = plan._derived[key] = gather_tables(plan, esz)
    return tables


def last_launch() -> dict:
    """The last launch's grid as the C side chose it: ``groups`` (of
    planes), ``col_tiles``, ``row_tiles``, ``smem`` bytes a block and
    ``blocks_per_sm`` resident (a diagnostic, read off the launch path)."""
    info = (ctypes.c_int * 5)()
    _build.load_library().hg_plan_gather_last_launch(info)
    return dict(zip(("groups", "col_tiles", "row_tiles", "smem",
                     "blocks_per_sm"), info))


def plan_gather(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Execute ``plan`` on ``image`` ``(..., H, W)`` through the op
    ``hygrid::plan_gather`` on the plan's cached tables.

    A CPU tensor runs the plain version (:func:`apply_plan`'s gather-blend
    on the dense plan the tables encode, bit-equal to it).  A CUDA tensor
    (float32 or bfloat16, contiguous) launches the kernel; anything else
    raises.  The result has the image's dtype and shape ``(..., h1, w1)``;
    its gradient is :func:`plan_gather_vjp_plain` on either device, traced
    as the span ``hygrid.resample_backward``.
    """
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plan_gather: no kernel for device {image.device}")
    return _PlanGather.apply(image, plan)


def plan_gather_vjp_plain(grad: torch.Tensor, plan: SamplePlan
                          ) -> torch.Tensor:
    """Transpose of the plan: ``d[..., idx[k, p]] += w[k, p] * grad[..., p]``
    summed in float32, returned ``(..., H, W)`` in ``grad``'s dtype (twin
    of ``resample_pallas._apply_plan_pallas_bwd``)."""
    h, w = plan.src_shape
    idx, weights = plan.tensors(grad.device)
    lead = tuple(grad.shape[:-2])
    g = grad.reshape(-1, 1, idx.shape[1]).float()         # (N, 1, P)
    contrib = (g * weights).reshape(g.shape[0], -1)       # (N, K*P)
    out = contrib.new_zeros((g.shape[0], h * w))
    out.index_add_(1, idx.reshape(-1), contrib)
    return out.reshape(lead + (h, w)).to(grad.dtype)


class _PlanGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, plan):
        ctx.plan = plan
        return _launch(image, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        with span("hygrid.resample_backward"):
            return plan_gather_vjp_plain(grad, ctx.plan), None


def _launch(image: torch.Tensor, plan: SamplePlan,
            tables: GatherTables = None) -> torch.Tensor:
    """``hygrid::plan_gather`` on ``plan``'s cached tables, or on ``tables``
    (:func:`gather_tables` of this plan and the image's element size)."""
    return _OP(*_op_args(image, plan, tables))


def _op_args(image: torch.Tensor, plan: SamplePlan,
             tables: GatherTables = None) -> tuple:
    """``hygrid::plan_gather``'s arguments for :func:`_launch`."""
    h, w = plan.src_shape
    _check_image(image, h, w)
    esz = image.element_size()
    tables = tables if tables is not None else gather_tables_cached(plan, esz)
    if tables.esz != esz or tables.shape != plan.idx.shape + (h, w):
        raise ValueError("plan_gather: the tables are not this plan's at "
                         "this element size")
    tabs = tables.tensors(image.device)
    return (image, *(tabs[n] for n in _TABLES), h, w, *plan.out_shape, esz,
            tables.index_form, tables.weight_form, tables.band_rows,
            tables.band_pitch, plan.exact_select)


# the op's table inputs, in the order of GatherTables.arrays and the C
# side's TableArgs
_TABLES = ("idx", "dk", "weights", "rowf", "colf", "rowbase", "tile_row_lo",
           "tile_col_lo")


def _out_dtype(dtype: torch.dtype, exact_select: bool) -> torch.dtype:
    """:func:`apply_plan`'s result dtype: floating images and exact-select
    plans keep the image's, other integer blends give float32."""
    return dtype if dtype.is_floating_point or exact_select else \
        torch.float32


def dense_plan(idx, dk, weights, rowf, colf, rowbase, tile_col_lo, w: int,
               h1: int, w1: int, esz: int, index_form: str,
               weight_form: str):
    """``(idx (K, h1*w1) int64, weights (K, h1*w1) float32)``: the dense
    plan that a :class:`GatherTables`' tensors encode, computed in torch
    on their device (bit-equal to ``plan.idx`` and ``plan.weights``)."""
    k, dev = idx.shape[0], idx.device
    if weight_form == "factored":
        weights = _factored_weights(rowf, colf, w1)
    weights = weights.reshape(k, -1)
    if index_form == "dense":
        return idx.reshape(k, -1).long(), weights
    seg = tile_width(esz)
    r = torch.arange(h1, device=dev)
    lo = tile_col_lo[(r // TILE_ROWS)[:, None],
                     (torch.arange(w1, device=dev) // seg)[None, :]].long()
    if index_form == "parity":
        col = idx[:, r % 2, :w1].long()
        d = dk[:, :, None].long()
    else:
        e = idx.reshape(k, h1, w1).long() & 0xFFFF       # col << 1 | d
        col, d = e >> 1, e & 1
    rows = rowbase[None, :, None].long() + d
    return (rows * w + lo[None] + col).reshape(k, -1), weights


def _check_image(image, h, w):
    if tuple(image.shape[-2:]) != (h, w):
        raise ValueError(f"image spatial shape {tuple(image.shape[-2:])} != "
                         f"plan source {(h, w)}")


def _plan_gather_cpu(image, idx, dk, weights, rowf, colf, rowbase,
                     tile_row_lo, tile_col_lo, h, w, h1, w1, esz, index_form,
                     weight_form, band_rows, band_pitch, exact_select):
    """The op's plain version: :func:`apply_plan`'s gather-blend on the
    tables' dense plan."""
    _check_image(image, h, w)
    gidx, gw = dense_plan(idx, dk, weights, rowf, colf, rowbase, tile_col_lo,
                          w, h1, w1, esz, index_form, weight_form)
    return gather_blend(image, gidx, gw, (h1, w1), exact_select)


def _plan_gather_cuda(image, idx, dk, weights, rowf, colf, rowbase,
                      tile_row_lo, tile_col_lo, h, w, h1, w1, esz, index_form,
                      weight_form, band_rows, band_pitch, exact_select):
    """The op's launch of ``csrc/plan_gather.cu``, counted as
    ``"plan_gather"`` (``utils.profiling.counts``)."""
    if image.dtype not in _DTYPES:
        raise TypeError(f"plan_gather: the kernel takes float32 or bfloat16 "
                        f"images, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("plan_gather: the image must be contiguous")
    _check_image(image, h, w)
    tabs = (idx, dk, weights, rowf, colf, rowbase, tile_row_lo, tile_col_lo)
    k = idx.shape[0]
    if k > _MAX_TAPS:
        raise ValueError(f"plan_gather: at most {_MAX_TAPS} taps, got {k}")
    if esz != image.element_size() or any(
            t is not None and t.device != image.device for t in tabs):
        raise ValueError(f"plan_gather: the tables must be for "
                         f"{image.element_size()}-byte elements on "
                         f"{image.device}")
    lead = tuple(image.shape[:-2])
    n_planes = image.numel() // (h * w)
    out = torch.empty(lead + (h1, w1), dtype=image.dtype,
                      device=image.device)
    if n_planes == 0:
        return out
    seg = tile_width(esz)
    args = _TableArgs(*(None if t is None else t.data_ptr() for t in tabs),
                      h, w, h1, w1, -(-w1 // seg) * seg, k,
                      _INDEX_FORMS[index_form], _WEIGHT_FORMS[weight_form],
                      band_rows, band_pitch, seg)
    lib = _build.load_library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_plan_gather(
            image.data_ptr(), out.data_ptr(), _DTYPES[image.dtype], n_planes,
            ctypes.addressof(args), stream)
    _build.check(status, "plan_gather")
    count("plan_gather")
    return out


def _plan_gather_fake(image, idx, dk, weights, rowf, colf, rowbase,
                      tile_row_lo, tile_col_lo, h, w, h1, w1, esz, index_form,
                      weight_form, band_rows, band_pitch, exact_select):
    return image.new_empty(tuple(image.shape[:-2]) + (h1, w1),
                           dtype=_out_dtype(image.dtype, exact_select))


_OP = _ops.define(
    "plan_gather(Tensor image, Tensor idx, Tensor? dk, Tensor? weights, "
    "Tensor? rowf, Tensor? colf, Tensor? rowbase, Tensor? tile_row_lo, "
    "Tensor? tile_col_lo, int h, int w, int h1, int w1, int esz, "
    "str index_form, str weight_form, int band_rows, int band_pitch, "
    "bool exact_select) -> Tensor",
    cpu=_plan_gather_cpu, cuda=_plan_gather_cuda, fake=_plan_gather_fake)
