"""Shift-structured resampler (``csrc/shift_resample.cu``).

Port of ``hygrid_tpu/kernels/resample_shift.py`` (``_shift_kernel_full``
and ``_shift_kernel_banded``), built on the row-band decomposition
(``resample.rowsep_decompose``).  Many plans map output column ``j`` to
source columns ``(num * j) // den + s`` for a few integer shifts ``s`` and
read two source rows ``rowbase[r] + d`` per output row ``r``.  :func:`shift_decompose` finds that structure and sums the plan's
weights per slot ``(d, s)``; then

    out[n, r, j] = sum_i  W[i, r, j] * src[n, rowbase[r] + d_i, (num*j)//den + s_i]

over the slots ``i`` in the order of ``geo.slots``, with a source column
outside ``[0, W)`` reading 0.  ``W`` is ``wplanes[i, r, j]``; the kernel
reads it from the smallest exact form :func:`shift_decompose` finds
(``geo.form``), each indexed by the row's phase ``phase_idx[r]``:

* ``"select"``: every weight is 0 or 1 with at most one 1 a pixel (the
  mosaic): one uint8 slot index a (phase, column), 255 for none;
* ``"phase"``: ``wphase`` (at most 64 phases and 4 MiB, the reference's
  phase mode), or ``"dense"``: ``(h1, n_slots, w1)`` indexed by r.

Each form expands to the same float32 numbers bit for bit
(:func:`expand_weights`).

The reference stores slot ``i`` as ``(d, u, a)``, with ``a`` relative to a
pre-stretched (``den > 1``) or de-interleaved (``num > 1``) copy of the
source.  Here ``s`` is the raw column shift (:func:`slot_shifts`) and no
copy is built.

Both versions accumulate in float32 (float64 for float64 images, plain
version only) with float32 weights and round once to the image dtype.
``hygrid_tpu`` ships the weights in bf16 where that is lossless; the sums
are the same.  The gradient is the transpose of the plan
(:func:`~hygrid_tpu_torch.kernels.resample.plan_gather_vjp_plain`), as the
reference's shift executor takes ``apply_plan_pallas``'s custom VJP
(``resample_pallas.py:432-457``).

:func:`shift_resample` calls the op ``hygrid::shift_resample``
(``_ops.py``) on the geometry's tables, its slots and strides: its CPU
implementation is :func:`shift_resample_plain`'s arithmetic, its CUDA one
the launch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..ops.sampling import SamplePlan
from ..utils.profiling import count, span
from . import _build, _ops
from .resample import (_check_image, _out_dtype, rowsep_decompose,
                       rowsep_decompose_cached)

__all__ = ["rowsep_decompose", "ShiftGeometry", "expand_weights",
           "shift_decompose", "shift_decompose_cached", "slot_shifts",
           "shift_resample", "shift_resample_plain"]

_MAX_SHIFTS = 8
_MAX_SLOTS = 10
_STRIDES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (4, 1), (1, 3), (3, 1))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the weight table's forms, as csrc/shift_resample.cu numbers them
_FORMS = {"dense": 0, "phase": 1, "select": 2}
_SELECT_NONE = 255     # a select table's "no slot": the pixel reads 0
_ONE_BITS = 0x3F800000


@dataclasses.dataclass(frozen=True)
class ShiftGeometry:
    """Decomposition of a shift-structured plan (fields bit-equal to
    ``hygrid_tpu``'s).

    ``slots[i] = (d, u, a)``: row-part d reads de-interleaved source plane u
    (always 0 unless downsampling) at lane shift ``a`` relative to output
    column j; ``wplanes[i]`` carries that slot's per-(row, column) weights
    (the sum of every plan term that lands on the slot, accumulated in the
    plan's k order).
    """
    num: int                      # column stride numerator (downsample Q)
    den: int                      # column stride denominator (upsample Q)
    slots: tuple                  # ((d, u, a), ...)
    wplanes: np.ndarray           # (n_slots, h1, w1) float32
    rowbase: np.ndarray           # (h1,) int32
    phase_idx: np.ndarray         # (h1,) int32
    n_phases: int
    phase_mode: bool
    wphase: np.ndarray            # (n_phases, n_slots, w1) f32 (phase mode)
    form: str = "dense"           # the kernel's table: see the module note
    table: np.ndarray = None      # "select": uint8 (n_phases, w1)
    _device_copies: Dict[str, dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def tensors(self, device) -> dict:
        """The kernel's tables on ``device``, uploaded once per geometry
        and device: ``rowbase`` (h1,) int32, ``phase_idx`` (h1,) int32 or
        None (dense), ``wtab`` (``geo.form``'s table: uint8 ``(n_phases,
        w1)`` for "select", float32 ``(n_phases, n_slots, w1)`` for
        "phase", ``(h1, n_slots, w1)`` for "dense"), ``table_bytes`` (its
        size), and the slots' row parts and raw column shifts as lists
        (``slot_d``, ``slot_s``)."""
        key = str(torch.device(device))
        tabs = self._device_copies.get(key)
        if tabs is None:
            wtab = {"select": self.table,
                    "phase": self.wphase}.get(self.form)
            if wtab is None:
                wtab = self.wplanes.transpose(1, 0, 2)
            wtab = torch.from_numpy(np.ascontiguousarray(wtab)).to(device)
            shifts = slot_shifts(self)
            tabs = dict(
                rowbase=torch.from_numpy(self.rowbase).to(device),
                phase_idx=(None if self.form == "dense" else
                           torch.from_numpy(self.phase_idx).to(device)),
                wtab=wtab, table_bytes=wtab.numel() * wtab.element_size(),
                slot_d=[d for d, _ in shifts], slot_s=[s for _, s in shifts])
            self._device_copies[key] = tabs
        return tabs


def _select_table(wplanes: np.ndarray, first_rows):
    """The "select" table of the slot weights ``wplanes`` at the phases'
    first rows, uint8 ``(n_phases, w1)``, where every weight is 0.0 or 1.0
    with at most one 1.0 a pixel (compared bit for bit); else None."""
    bits = np.ascontiguousarray(wplanes[:, first_rows, :]).view(np.uint32)
    one = bits == _ONE_BITS                                  # (S, P, w1)
    if (len(bits) >= _SELECT_NONE or not np.all(one | (bits == 0))
            or one.sum(axis=0).max() > 1):
        return None
    sel = np.where(one.any(axis=0), one.argmax(axis=0), _SELECT_NONE)
    return sel.astype(np.uint8)


def expand_weights(geo: ShiftGeometry, tabs: dict) -> torch.Tensor:
    """The float32 ``(h1, n_slots, w1)`` weights that ``geo.form``'s table
    ``tabs["wtab"]`` (from :meth:`ShiftGeometry.tensors`) encodes, on its
    device: bit-equal to ``geo.wplanes.transpose(1, 0, 2)``."""
    return _expand(tabs["wtab"], tabs["phase_idx"], geo.form, len(geo.slots))


def _expand(wtab, phase_idx, form: str, n_slots: int) -> torch.Tensor:
    """:func:`expand_weights` on the table ``wtab`` of ``form``, indexed by
    the rows' ``phase_idx`` (None for "dense")."""
    if form == "dense":
        return wtab
    rows = wtab[phase_idx.long()]
    if form == "select":                               # (h1, w1) uint8
        slots = torch.arange(n_slots, device=rows.device)
        return (rows[:, None, :].long() == slots[None, :, None]).float()
    return rows


def shift_decompose(plan: SamplePlan, max_shifts: int = _MAX_SHIFTS):
    """Detect constant column stride and build slot weight planes, or None.

    Works from the row-band decomposition; the extra condition is that
    ``cols - (num*j)//den`` takes at most ``max_shifts`` distinct values
    over the live (weight != 0) entries.
    """
    dec = rowsep_decompose_cached(plan)
    if dec is None:
        return None
    rowbase, cols, wts = dec
    _, k, h1, w1 = cols.shape
    valid = wts != 0
    if not valid.any():
        return None
    j = np.arange(w1, dtype=np.int64)
    for num, den in _STRIDES:
        base = (num * j) // den
        delta = cols - base[None, None, None, :]
        shifts = np.unique(delta[valid])
        if len(shifts) <= max_shifts:
            break
    else:
        return None

    slots, planes = [], []
    for d in (0, 1):
        for s in shifts:
            wpl = np.zeros((h1, w1), np.float32)
            live = False
            for kk in range(k):
                m = valid[d, kk] & (delta[d, kk] == s)
                if m.any():
                    wpl = np.where(m, wpl + wts[d, kk], wpl)
                    live = True
            if live:
                s = int(s)
                if den > 1:          # pre-stretched source: stride-1 @ den*s
                    slots.append((d, 0, den * s))
                else:                # de-interleaved plane u, shift s//num
                    slots.append((d, s % num, s // num))
                planes.append(wpl)
    if not slots or len(slots) > _MAX_SLOTS:
        return None
    wplanes = np.stack(planes)

    # row-phase dedup: bit-identical weight rows share a phase
    row_key: dict = {}
    phase_idx = np.empty(h1, np.int32)
    first_rows: list = []
    for r in range(h1):
        dg = hashlib.blake2b(wplanes[:, r, :].tobytes(), digest_size=16)
        p = row_key.setdefault(dg.digest(), len(row_key))
        if p == len(first_rows):
            first_rows.append(r)
        phase_idx[r] = p
    n_phases = len(first_rows)
    phase_mode = n_phases <= 64 and \
        n_phases * len(slots) * w1 * 4 <= 4 * 2**20
    wphase = (wplanes[:, np.asarray(first_rows), :].transpose(1, 0, 2).copy()
              if phase_mode else np.zeros((0,), np.float32))
    # the kernel's table: a slot index a (phase, column) where the plan only
    # selects, else the phase or dense table
    table = _select_table(wplanes, np.asarray(first_rows))
    form = ("select" if table is not None else
            "phase" if phase_mode else "dense")
    return ShiftGeometry(
        num=num if den == 1 else 1, den=den, slots=tuple(slots),
        wplanes=wplanes, rowbase=rowbase.astype(np.int32),
        phase_idx=phase_idx, n_phases=n_phases, phase_mode=phase_mode,
        wphase=wphase, form=form, table=table)


def shift_decompose_cached(plan: SamplePlan):
    """:func:`shift_decompose`, computed once per plan and kept on it, so
    that the geometry and its device tables live exactly as long as the
    plan (plans are interned by the geometry-level and view caches; the
    decomposition is a full numpy pass)."""
    if "shift" not in plan._derived:
        plan._derived["shift"] = shift_decompose(plan)
    return plan._derived["shift"]


def slot_shifts(geo: ShiftGeometry):
    """``[(d, s), ...]``: each slot's row part and raw column shift, so
    that slot i reads source column ``(num * j) // den + s``."""
    def raw(u, a):
        if geo.den > 1:
            return a // geo.den
        return a * geo.num + u
    return [(d, raw(u, a)) for d, u, a in geo.slots]


def shift_resample_plain(image: torch.Tensor, plan: SamplePlan,
                         geo: ShiftGeometry = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: per slot,
    gather the shifted source rows and columns and add ``W * value`` to a
    float32 accumulator (float64 for float64 images), in slot order.
    Floating images come back in their dtype, others in float32."""
    geo = geo if geo is not None else shift_decompose_cached(plan)
    if geo is None:
        raise ValueError("plan is not shift-structured")
    return _shift_cpu(image, *_op_args(plan, geo, image.device))


def _op_args(plan: SamplePlan, geo: ShiftGeometry, device) -> tuple:
    """``hygrid::shift_resample``'s arguments after the image: the
    geometry's tables on ``device``, its form, the slots' row parts and
    raw column shifts, the plan's shapes and the column stride."""
    tabs = geo.tensors(device)
    return (tabs["rowbase"], tabs["phase_idx"], tabs["wtab"], geo.form,
            tabs["slot_d"], tabs["slot_s"],
            *plan.src_shape, *plan.out_shape, geo.num, geo.den)


def _shift_cpu(image, rowbase, phase_idx, wtab, form, slot_d, slot_s, h, w,
               h1, w1, num, den):
    """The op's plain version: :func:`shift_resample_plain`'s sums from the
    op's inputs."""
    _check_image(image, h, w)
    lead = tuple(image.shape[:-2])
    x = image.reshape((-1, h, w))
    dev = image.device
    acc_dtype = (torch.float64 if image.dtype == torch.float64
                 else torch.float32)
    wtab = _expand(wtab, phase_idx, form, len(slot_d))   # (h1, n_slots, w1)
    rowbase = rowbase.long()
    base = (num * torch.arange(w1, device=dev)) // den
    acc = torch.zeros((x.shape[0], h1, w1), dtype=acc_dtype, device=dev)
    for i, (d, s) in enumerate(zip(slot_d, slot_s)):
        cols = base + s
        inside = (cols >= 0) & (cols < w)
        v = x[:, rowbase + d][:, :, cols.clamp(0, w - 1)].to(acc_dtype)
        v = torch.where(inside, v, torch.zeros((), dtype=acc_dtype,
                                               device=dev))
        acc = acc + v * wtab[:, i, :].to(acc_dtype)
    return acc.to(_out_dtype(image.dtype, False)).reshape(lead + (h1, w1))


def shift_resample(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Execute a shift-structured ``plan`` on ``image`` ``(..., H, W)``
    through the op ``hygrid::shift_resample`` on the plan's cached tables.

    A CPU tensor runs :func:`shift_resample_plain`.  A CUDA tensor (float32
    or bfloat16, contiguous) launches the kernel; anything else raises, as
    does a plan that :func:`shift_decompose` refuses.  The result has the
    image's dtype and shape ``(..., h1, w1)``; its gradient is the plan's
    transpose on either device, traced as the span
    ``hygrid.resample_backward``.
    """
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"shift_resample: no kernel for device {image.device}")
    return _ShiftResample.apply(image, plan)


class _ShiftResample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, plan):
        ctx.plan = plan
        geo = shift_decompose_cached(plan)
        if geo is None:
            raise ValueError("shift_resample: plan is not shift-structured")
        _check_image(image, *plan.src_shape)
        return _OP(image, *_op_args(plan, geo, image.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        from .resample import plan_gather_vjp_plain
        with span("hygrid.resample_backward"):
            return plan_gather_vjp_plain(grad, ctx.plan), None


def _shift_cuda(image, rowbase, phase_idx, wtab, form, slot_d, slot_s, h, w,
                h1, w1, num, den):
    """The op's launch of ``csrc/shift_resample.cu``, counted as
    ``"shift_resample"`` (``utils.profiling.counts``)."""
    if image.dtype not in _DTYPES:
        raise TypeError(f"shift_resample: the kernel takes float32 or "
                        f"bfloat16 images, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("shift_resample: the image must be contiguous")
    _check_image(image, h, w)
    if any(t is not None and t.device != image.device
           for t in (rowbase, phase_idx, wtab)):
        raise ValueError(f"shift_resample: the tables must be on "
                         f"{image.device}")
    lead = tuple(image.shape[:-2])
    n_planes = image.numel() // (h * w)
    out = torch.empty(lead + (h1, w1), dtype=image.dtype, device=image.device)
    if n_planes == 0:
        return out
    slot_d = np.asarray(slot_d, np.int32)
    slot_s = np.asarray(slot_s, np.int32)
    lib = _build.load_library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_shift_resample(
            image.data_ptr(), out.data_ptr(), rowbase.data_ptr(),
            None if phase_idx is None else phase_idx.data_ptr(),
            wtab.data_ptr(), _FORMS[form], slot_d.ctypes.data,
            slot_s.ctypes.data, len(slot_d), n_planes, h, w, h1, w1, num,
            den, _DTYPES[image.dtype], stream)
    _build.check(status, "shift_resample")
    count("shift_resample")
    return out


def _shift_fake(image, rowbase, phase_idx, wtab, form, slot_d, slot_s, h, w,
                h1, w1, num, den):
    return image.new_empty(tuple(image.shape[:-2]) + (h1, w1),
                           dtype=_out_dtype(image.dtype, False))


_OP = _ops.define(
    "shift_resample(Tensor image, Tensor rowbase, Tensor? phase_idx, "
    "Tensor wtab, str form, int[] slot_d, int[] slot_s, int h, int w, "
    "int h1, int w1, int num, int den) -> Tensor",
    cpu=_shift_cpu, cuda=_shift_cuda, fake=_shift_fake)
