"""Exact hex-lattice rotations and reflections, PyTorch port of
``hygrid_tpu/ops/hexrot.py``.

Rotation by a multiple of 60 degrees is an exact permutation of cells: a
K=1 exact-select :class:`~hygrid_tpu_torch.ops.sampling.SamplePlan`, built
in numpy (bit-equal to the reference's) and cached by shape, ``k`` and
pivot.  It runs through :func:`~hygrid_tpu_torch.ops.sampling.apply_plan_auto`
like every plan of the package.  A rotated output row spans many source
rows, so the plan has no row-band form: floating images take
``plan_gather``'s dense form on the card (the reference's TPU routing gave
it XLA), 8-bit images go through bfloat16 and back bit-exactly, wider
integers take the plain ``apply_plan``.

Axial correspondence for the brick-wall storage (offset-0, odd rows shifted
right): ``r = i``, ``q = j - (i - (i % 2)) // 2``; rotation by 60 degrees in
axial coordinates is ``(q, r) -> (-r, q + r)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import sampling

__all__ = ["hexrot60", "hexflip"]

_PLAN_CACHE: dict = {}


def _axial_of(i, j):
    return j - (i - (i % 2)) // 2, i


def _offset_of(q, r):
    return r, q + (r - (r % 2)) // 2


def _rot_axial(q, r, k):
    for _ in range(k % 6):
        q, r = -r, q + r
    return q, r


def _build_rot_plan(h: int, w: int, k: int,
                    pivot: Optional[Tuple[int, int]]) -> sampling.SamplePlan:
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    q, r = _axial_of(ii, jj)
    pi, pj = pivot if pivot is not None else (h // 2, w // 2)
    qc, rc = _axial_of(np.array(pi), np.array(pj))
    q2, r2 = _rot_axial(q - qc, r - rc, k)
    io, jo = _offset_of(q2 + qc, r2 + rc)
    io = io - io.min()
    jo = jo - jo.min()
    h1, w1 = int(io.max()) + 1, int(jo.max()) + 1
    src = np.full((h1, w1), -1, np.int64)
    src[io, jo] = (ii * w + jj).ravel().reshape(h, w)
    mask = src >= 0
    idx = np.where(mask, src, 0).astype(np.int32)
    return sampling.SamplePlan(idx[None], mask[None].astype(np.float32),
                               (h, w), (h1, w1), exact_select=True)


def rot_plan(h: int, w: int, k: int = 1,
             pivot: Optional[Tuple[int, int]] = None) -> sampling.SamplePlan:
    """The cached plan of :func:`hexrot60` for an ``(h, w)`` image."""
    key = (h, w, k % 6, pivot)
    if key not in _PLAN_CACHE:
        if len(_PLAN_CACHE) > 64:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = _build_rot_plan(h, w, k, pivot)
    return _PLAN_CACHE[key]


def _as_tensor(image, device) -> torch.Tensor:
    if torch.is_tensor(image):
        return image
    return torch.as_tensor(np.asarray(image), device=device)


def hexrot60(image, k: int = 1, pivot: Optional[Tuple[int, int]] = None,
             device="cuda"):
    """Rotate a hex image (..., H, W) by ``k * 60`` degrees exactly.

    Every source cell lands on exactly one output cell (values preserved
    bit for bit, integer dtypes included); cells of the output canvas
    outside the rotated support are zero.  ``pivot`` is the storage index
    of the rotation centre (default: the centre cell).  ``hexrot60(x, 6)``
    is the identity.  A tensor rotates on its own device; other input goes
    to ``device`` first.
    """
    image = _as_tensor(image, device)
    h, w = image.shape[-2:]
    return sampling.apply_plan_auto(image.contiguous(),
                                    rot_plan(h, w, k, pivot))


def hexflip(image, axis: str = "horizontal", device="cuda"):
    """Exact hex-lattice mirror: ``"horizontal"`` reverses the columns,
    ``"vertical"`` the rows (pure permutations)."""
    image = _as_tensor(image, device)
    if axis == "horizontal":
        return torch.flip(image, dims=(-1,))
    if axis == "vertical":
        return torch.flip(image, dims=(-2,))
    raise ValueError(axis)
