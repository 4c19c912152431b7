"""Unified resampling engine (layer L2 core), PyTorch port of
``hygrid_tpu/ops/sampling.py``.

* **Plan** — sample coordinates -> gather indices and blend weights, built
  once in float64 numpy (bit-equal to ``hygrid_tpu``'s plans).
* **Apply** — the gather-and-blend on a tensor of any device.
  :func:`apply_plan` is the plain PyTorch version; :func:`apply_plan_auto`
  hands the tensor to the shift resampler (``kernels/resample_shift.py``)
  or the plan-gather kernel (``kernels/resample.py``), by the plan's
  structure; each launches its CUDA kernel for a CUDA tensor and runs its
  plain version for a CPU tensor.

Deliberate difference from ``hygrid_tpu``: for floating images the blend
accumulates in float32 (float64 for float64 images) with float32 weights,
and rounds once to the image dtype.  ``hygrid_tpu``'s XLA ``apply_plan``
accumulates bf16 images in bf16, and its TPU kernel ships bf16 weights for
bf16 images; in float32 the two packages agree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import lattice

__all__ = [
    "SamplePlan",
    "hex_sample_plan",
    "rect_sample_plan",
    "apply_plan",
    "apply_plan_auto",
    "takes_shift_route",
]


@dataclasses.dataclass(frozen=True, eq=False)
class SamplePlan:
    """Gather/blend recipe for one resampling op.

    Attributes:
        idx: ``(K, h1, w1)`` int32 flattened source indices (``i * W + j``),
            clamped into range.
        weights: ``(K, h1, w1)`` float32 blend weights; out-of-range
            contributions carry weight 0.
        src_shape: ``(H, W)`` of the source image.
        out_shape: ``(h1, w1)``.
        exact_select: True when K == 1 and weights are pure 0/1 masks
            (nearest modes) — lets ``apply_plan`` preserve integer dtypes.
    """

    idx: np.ndarray
    weights: np.ndarray
    src_shape: Tuple[int, int]
    out_shape: Tuple[int, int]
    exact_select: bool = False
    _device_copies: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, repr=False)
    # results derived from the plan (its row-band and shift decompositions,
    # the kernels' tables, the rect->hex factors), which live and die with
    # it
    _derived: Dict[str, object] = dataclasses.field(default_factory=dict,
                                                    repr=False)

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(idx, weights)`` as contiguous ``(K, h1*w1)`` int32 / float32
        tensors on ``device``, uploaded once per plan and device."""
        key = str(torch.device(device))
        pair = self._device_copies.get(key)
        if pair is None:
            k = self.idx.shape[0]
            pair = (torch.from_numpy(self.idx.reshape(k, -1)).to(device),
                    torch.from_numpy(self.weights.reshape(k, -1)).to(device))
            self._device_copies[key] = pair
        return pair

    def row_slice(self, r0: int, r1: int):
        """``(lo, hi, sub)``: the source rows ``lo..hi`` that output rows
        ``r0:r1`` read, and the plan of those output rows on that band.

        A rect->hex bilinear plan's factors (:func:`_rect_factors`) are
        sliced with it, so the band's kernel tables are factored as the
        whole plan's are."""
        w = self.src_shape[1]
        idx = self.idx[:, r0:r1]
        rows = idx // w
        lo, hi = int(rows.min()), int(rows.max())
        sub = SamplePlan(idx - lo * w, self.weights[:, r0:r1],
                         (hi - lo + 1, w), (r1 - r0, self.out_shape[1]),
                         self.exact_select)
        f = self._derived.get("rect_factors")
        if f is not None:
            # the column factors go by row parity: keep it for an odd r0
            par = [r0 % 2, (r0 + 1) % 2]
            sub._derived["rect_factors"] = dict(
                row=f["row"][r0:r1], row_valid=f["row_valid"][r0:r1],
                col=f["col"][par], col_valid=f["col_valid"][par])
        return lo, hi, sub


def _finalize(idx_list, w_list, h, w, exact_select=False):
    iidx = np.stack([np.clip(i, 0, h - 1) for i, _ in idx_list], axis=0)
    jidx = np.stack([np.clip(j, 0, w - 1) for _, j in idx_list], axis=0)
    flat = (iidx * w + jidx).astype(np.int32)
    weights = np.stack(w_list, axis=0).astype(np.float32)
    return SamplePlan(flat, weights, (h, w), flat.shape[1:], exact_select)


def hex_sample_plan(x, y, h: int, w: int, method: str) -> SamplePlan:
    """Plan for sampling a hex (brick-wall, offset-0) image at Cartesian
    points ``(x, y)`` (float64 numpy arrays).

    method: ``"linear"`` (barycentric over the 3 enclosing vertices),
    ``"nearest"`` (nearest vertex) or ``"bilinear"`` (two-stage lerp over
    the affine parallelogram of the 4 de-skewed neighbours); see
    ``hygrid_tpu.ops.sampling.hex_sample_plan`` for the reference notes.
    """
    xp = np
    i_, j_ = lattice.affine_index(x, y, h, w)
    i_n = lattice._trunc_int(i_, xp)
    j_n = lattice._trunc_int(j_, xp)
    i_f = i_ - i_n
    j_f = j_ - j_n

    (i1, j1), (i2, j2), (i3, j3), (i4, j4) = lattice.hex_neighbors(i_n, j_n, xp)

    def valid(i, j):
        return ((i >= 0) & (j >= 0) & (i < h) & (j < w))

    flag, p1, p2, p3 = lattice.triangle_vertices(i_n, j_n, i_f, j_f, h, w, xp)

    # vertex 2 of the triangle is neighbour 2 (next row) in the upper
    # triangle, neighbour 3 (same row) in the lower
    i2s = xp.where(flag, i2, i3)
    j2s = xp.where(flag, j2, j3)
    v1 = valid(i1, j1)
    v2 = xp.where(flag, valid(i2, j2), valid(i3, j3))
    v3 = valid(i4, j4)

    fdt = x.dtype
    if method == "linear":
        a, b, g = lattice.triangle_weights_linear(x, y, p1, p2, p3, xp)
        w1_ = a * v1.astype(fdt)
        w2_ = b * v2.astype(fdt)
        w3_ = g * v3.astype(fdt)
        return _finalize([(i1, j1), (i2s, j2s), (i4, j4)], [w1_, w2_, w3_], h, w)
    if method == "nearest":
        sel = lattice.triangle_select_nearest(x, y, p1, p2, p3, xp)
        ii = xp.where(sel == 0, i1, xp.where(sel == 1, i2s, i4))
        jj = xp.where(sel == 0, j1, xp.where(sel == 1, j2s, j4))
        vv = xp.where(sel == 0, v1, xp.where(sel == 1, v2, v3))
        return _finalize([(ii, jj)], [vv.astype(fdt)], h, w, exact_select=True)
    if method == "bilinear":
        vall = [valid(i1, j1), valid(i2, j2), valid(i3, j3), valid(i4, j4)]
        ws = [(1 - i_f) * (1 - j_f), i_f * (1 - j_f),
              (1 - i_f) * j_f, i_f * j_f]
        return _finalize(
            [(i1, j1), (i2, j2), (i3, j3), (i4, j4)],
            [wk * vk.astype(fdt) for wk, vk in zip(ws, vall)], h, w)
    raise ValueError(f"unsupported hex sampling method {method!r}")


def rect_sample_plan(x, y, h: int, w: int, method: str,
                     nearest_metric: str = "reference") -> SamplePlan:
    """Plan for sampling a rectangular image at Cartesian points ``(x, y)``
    (image-centered coordinates): ``"nearest"`` or ``"bilinear"``.

    ``nearest_metric="reference"`` replicates the reference's mixed-frame
    distance (always the truncated cell for H, W >= 3); ``"euclidean"`` is
    the true nearest neighbour (see ``hygrid_tpu.ops.sampling``).
    """
    xp = np
    i_ = x + (h - 1) * 0.5
    j_ = y + (w - 1) * 0.5
    i_n = lattice._trunc_int(i_, xp)
    j_n = lattice._trunc_int(j_, xp)
    i_f = i_ - i_n
    j_f = j_ - j_n

    nbrs = [(i_n, j_n), (i_n, j_n + 1), (i_n + 1, j_n), (i_n + 1, j_n + 1)]

    def valid(i, j):
        return ((i >= 0) & (j >= 0) & (i < h) & (j < w))

    vs = [valid(i, j) for i, j in nbrs]
    fdt = x.dtype

    if method == "nearest":
        if nearest_metric == "reference":
            sx, sy = x, y  # mixed-frame distances, see docstring
        elif nearest_metric == "euclidean":
            sx, sy = i_, j_
        else:
            raise ValueError(f"unknown nearest_metric {nearest_metric!r}")
        ds = [(sx - i) ** 2 + (sy - j) ** 2 for i, j in nbrs]
        sel = xp.argmin(xp.stack(ds, axis=0), axis=0)
        ii = nbrs[0][0] + (sel >= 2).astype(i_n.dtype)
        jj = nbrs[0][1] + (sel % 2).astype(j_n.dtype)
        vv = xp.where(sel == 0, vs[0], xp.where(sel == 1, vs[1],
                      xp.where(sel == 2, vs[2], vs[3])))
        return _finalize([(ii, jj)], [vv.astype(fdt)], h, w, exact_select=True)
    if method == "bilinear":
        w1_ = (1 - j_f) * (1 - i_f) * vs[0].astype(fdt)
        w2_ = j_f * (1 - i_f) * vs[1].astype(fdt)
        w3_ = (1 - j_f) * i_f * vs[2].astype(fdt)
        w4_ = j_f * i_f * vs[3].astype(fdt)
        plan = _finalize(nbrs, [w1_, w2_, w3_, w4_], h, w)
        factors = _rect_factors(i_, j_, i_n, j_n, i_f, j_f, h, w)
        if factors is not None:
            plan._derived["rect_factors"] = factors
        return plan
    raise ValueError(f"unsupported rect sampling method {method!r}")


def _rect_factors(i_, j_, i_n, j_n, i_f, j_f, h, w):
    """The bilinear plan's float64 factors where its sample rows are
    constant along each output row and its sample columns repeat by row
    parity (the rect->hex grids), else None.

    ``row (h1, 2)``: ``(1 - i_f, i_f)`` a row; ``col (2, w1, 2)``:
    ``(1 - j_f, j_f)`` by row parity; ``row_valid (h1, 2)`` and
    ``col_valid (2, w1, 2)``: 1.0 where row ``i_n + a`` (column ``j_n + b``)
    lies in the source, else 0.0.  Tap ``k = 2a + b`` has the weight
    ``float32((col[r % 2, c, b] * row[r, a]) * (row_valid[r, a] *
    col_valid[r % 2, c, b]))``, the products above in their order;
    ``kernels/resample.py::gather_tables`` checks that bit for bit before
    it uses them."""
    if i_.ndim != 2 or i_.dtype != np.float64 or j_.dtype != np.float64:
        return None
    h1 = i_.shape[0]
    par = np.arange(h1) % 2
    if not (np.array_equal(i_, np.repeat(i_[:, :1], i_.shape[1], 1))
            and np.array_equal(j_, j_[par])):
        return None
    rows = i_n[:, 0]
    cols = j_n[:2] if h1 > 1 else j_n[[0, 0]]
    jf = j_f[:2] if h1 > 1 else j_f[[0, 0]]

    def inside(i, n):
        return ((i >= 0) & (i < n)).astype(np.float64)

    return dict(
        row=np.stack([1 - i_f[:, 0], i_f[:, 0]], -1),
        col=np.stack([1 - jf, jf], -1),
        row_valid=np.stack([inside(rows, h), inside(rows + 1, h)], -1),
        col_valid=np.stack([inside(cols, w), inside(cols + 1, w)], -1))


def apply_plan(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Execute a :class:`SamplePlan` on ``(..., H, W)``: the plain PyTorch
    gather-blend, on any device.

    ``out[..., p] = sum_k w[k, p] * image[..., idx[k, p]]``.  Floating
    images come back in their own dtype; integer images through an
    exact-select plan keep their dtype bit-exactly, other integer blends
    return float32 (as ``hygrid_tpu`` does).
    """
    h, w = plan.src_shape
    if tuple(image.shape[-2:]) != (h, w):
        raise ValueError(f"image spatial shape {tuple(image.shape[-2:])} != "
                         f"plan source {plan.src_shape}")
    idx, weights = plan.tensors(image.device)
    return gather_blend(image, idx, weights, plan.out_shape,
                        plan.exact_select)


def gather_blend(image: torch.Tensor, idx: torch.Tensor,
                 weights: torch.Tensor, out_shape, exact_select: bool
                 ) -> torch.Tensor:
    """:func:`apply_plan`'s arithmetic on a dense plan given as ``(K,
    h1*w1)`` source indices ``idx`` and float32 ``weights``: ``(..., H, W)``
    to ``(..., *out_shape)``."""
    lead = image.shape[:-2]
    flat = image.reshape(lead + (image.shape[-2] * image.shape[-1],))
    taken = flat.index_select(-1, idx.reshape(-1)).reshape(
        lead + idx.shape)                                 # (..., K, P)
    if exact_select:
        # one selected value per output cell: multiply by the 0/1 mask in
        # the image dtype so integer inputs round-trip bit-exactly
        out = taken[..., 0, :] * weights[0].to(image.dtype)
    else:
        # float64 blends in float64, everything else in float32
        acc = torch.float64 if image.dtype == torch.float64 else torch.float32
        out = (taken.to(acc) * weights.to(acc)).sum(dim=-2)
        if image.dtype.is_floating_point:
            out = out.to(image.dtype)
    return out.reshape(lead + tuple(out_shape))


# the reference's VMEM budget for the shift kernel's resident source
# (resample_shift.py:48): a structural gate copied only so that each path
# runs the counterpart of its TPU kernel, not an H100 threshold
_SHIFT_SOURCE_BYTES = 8 * 2 ** 20


def takes_shift_route(plan: SamplePlan, esz: int) -> bool:
    """Whether :func:`apply_plan_auto` runs ``plan`` on the shift resampler
    for an image of ``esz``-byte elements.

    Only where ``hygrid_tpu``'s TPU routing runs its shift kernel
    (``resample_shift.py::shift_prefers``): a shift-structured plan with a
    column stride other than 1, at least 640 output columns, and a source
    that the TPU kernel can hold resident (its pre-stretched or
    de-interleaved planes, padded to 128 lanes, at most 8 MiB).  These are
    the 720p video and the mosaic plans.  Unit-stride plans and larger
    sources (the 4K rect->hex leg) stay on the plan-gather kernel.  The
    gates are the TPU's, kept only so that each path runs its TPU kernel's
    counterpart; they are not H100 measurements.  On the device alone
    (CUDA-graph replay, ``chip_smoke.py`` phase 8, NVIDIA H100 80GB HBM3 at
    700 W) the plan-gather kernel is the faster of the two at these
    plans: the 4K mosaic 0.0575 ms against 0.0911 (bf16), 720p b=8 0.0405
    against 0.0614 (bf16), 1080p 0.0163 against 0.0257 (float32).
    """
    from ..kernels.resample_shift import shift_decompose_cached
    h, w = plan.src_shape
    # the resident planes hold at least the source (num planes of w / num
    # columns, or one of w * den), so a source over the budget is refused
    # before the decomposition, a numpy pass over the whole plan
    if plan.out_shape[1] < 640 or h * w * esz > _SHIFT_SOURCE_BYTES:
        return False
    geo = shift_decompose_cached(plan)
    if geo is None or (geo.num == 1 and geo.den == 1):
        return False
    # one stretched plane (den > 1, num == 1) or num de-interleaved planes
    w_eff = w * geo.den if geo.den > 1 else -(-w // geo.num)
    a_min = min(a for _, _, a in geo.slots)
    a_max = max(a for _, _, a in geo.slots)
    w1p = -(-plan.out_shape[1] // 128) * 128
    w_lane = -(-(max(0, -a_min) + max(w_eff, a_max + w1p)) // 128) * 128
    return geo.num * h * w_lane * esz <= _SHIFT_SOURCE_BYTES


def apply_plan_auto(image: torch.Tensor, plan: SamplePlan) -> torch.Tensor:
    """Plan execution through the port's resample kernels.

    The executor follows from the plan's structure and the image's element
    size, the same on every device: the shift resampler
    (``kernels/resample_shift.py``) where :func:`takes_shift_route` holds,
    else the plan-gather kernel (``kernels/resample.py``).  Each launches its CUDA kernel for a CUDA
    tensor and runs its plain version for a CPU tensor.  Integer images
    keep ``hygrid_tpu``'s rules: 8-bit images through an exact-select
    plan go through bfloat16 and back bit-exactly, other integer images
    run :func:`apply_plan`.
    """
    from ..kernels.resample import plan_gather
    from ..kernels.resample_shift import shift_resample
    image = torch.as_tensor(image)
    if not image.dtype.is_floating_point:
        if plan.exact_select and image.element_size() == 1:
            out = apply_plan_auto(image.to(torch.bfloat16), plan)
            return out.to(image.dtype)
        return apply_plan(image, plan)
    if takes_shift_route(plan, image.element_size()):
        return shift_resample(image, plan)
    return plan_gather(image, plan)
