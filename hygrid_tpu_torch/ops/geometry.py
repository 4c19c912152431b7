"""Public geometry / resampling API (layer L2), PyTorch port of
``hygrid_tpu/ops/geometry.py``.

Four thin coordinate generators over the one engine in
:mod:`hygrid_tpu_torch.ops.sampling`.  Output sizes and sample grids follow
``hygrid_tpu`` exactly (each function's corner box differs, see
``lattice.corner_box``); the gather plan is computed once in float64 numpy
and cached by shape and method, and each call is one gather-blend over all
leading (batch, channel) dims — through the resample kernels for a CUDA
tensor.  A tensor is resampled on its own device; numpy arrays and other
inputs are moved to ``device`` first, the card unless the caller asks for
the CPU (``hygrid_tpu`` puts them on JAX's default device).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import lattice
from ..utils.profiling import count, span
from . import sampling

__all__ = [
    "image_geometric_transformation",
    "hex_to_rect_resample",
    "rect_to_hex_resample",
    "hexresize",
    "warp_output_shape",
    "warp_plan",
    "hex_to_rect_plan",
    "rect_to_hex_plan",
    "hexresize_plan",
]

_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 256


def _cached_plan(key, builder) -> sampling.SamplePlan:
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        plan = builder()
        _PLAN_CACHE[key] = plan
    return plan


def _as_image(img, device) -> torch.Tensor:
    """Accept (H, W), (C, H, W) or (..., C, H, W) tensors or arrays, as a
    contiguous tensor.  A tensor stays on its device; anything else is
    moved to ``device``."""
    if not torch.is_tensor(img):
        img = torch.as_tensor(np.asarray(img), device=device)
    # the resample kernels take contiguous images (a channel slice is not)
    img = img.contiguous()
    if img.ndim < 2:
        raise ValueError(f"dim of image should be >= 2, but got dim = {img.ndim} instead")
    return img


def _ref_squeeze(out: torch.Tensor, in_ndim: int) -> torch.Tensor:
    """The reference squeezes all unit axes of <=3-D inputs; batched
    inputs are never squeezed."""
    return out.squeeze() if in_ndim <= 3 else out


def warp_output_shape(h: int, w: int, H=None) -> Tuple[int, int]:
    """Output (h1, w1) of :func:`image_geometric_transformation`."""
    hh, ww = _warp_axes(h, w, np.eye(3) if H is None
                        else np.asarray(H, dtype=np.float64))
    return len(hh), len(ww)


def _warp_axes(h: int, w: int, H: np.ndarray):
    """Output row and column coordinates of the warp: the transformed
    corner box, with the reference's float ``arange`` lengths."""
    h_inf, h_sup, w_inf, w_sup = lattice.corner_box("warp", h, w)
    nc = H @ np.array([[h_inf, h_inf, h_sup, h_sup],
                       [w_inf, w_sup, w_inf, w_sup],
                       [1.0, 1.0, 1.0, 1.0]])
    h1_inf, h1_sup = nc[0].min(), nc[0].max()
    w1_inf, w1_sup = nc[1].min(), nc[1].max()
    return (np.arange(h1_inf, h1_sup + 1, 1.0),
            np.arange(w1_inf, w1_sup + 0.5, 1.0))


def _warp_grid(h: int, w: int, H: np.ndarray):
    """Output brick-wall sample grid for the affine warp, inverse-mapped into
    source Cartesian coordinates (no homogeneous renormalisation: only
    affine H is meaningful, as in the reference)."""
    hh, ww = _warp_axes(h, w, H)
    gx, gy = np.meshgrid(hh, ww, indexing="ij")
    gy = gy.copy()
    gy[1::2] += 0.5  # output rows interleave: output offset is always 0
    ones = np.ones_like(gx)
    inv = np.linalg.inv(H)
    pts = np.einsum("ij,jkl->ikl", inv, np.stack([gx, gy, ones], axis=0))
    return pts[0], pts[1]


def _linspace_grid(box, h1: int, w1: int, hex_grid_shift: bool = False):
    h_inf, h_sup, w_inf, w_sup = box
    gx, gy = np.meshgrid(np.linspace(h_inf, h_sup, h1),
                         np.linspace(w_inf, w_sup, w1), indexing="ij")
    if hex_grid_shift:
        gy = gy.copy()
        step = (w_sup - w_inf) / (w1 - 1) if w1 > 1 else 0.0
        gy[1::2] += 0.5 * step
    return gx, gy


def warp_plan(h: int, w: int, H=None,
              interpolation: str = "nearest") -> sampling.SamplePlan:
    Hm = np.eye(3) if H is None else np.asarray(H, dtype=np.float64)
    key = ("warp", h, w, interpolation, Hm.tobytes())
    return _cached_plan(key, lambda: sampling.hex_sample_plan(
        *_warp_grid(h, w, Hm), h, w, interpolation))


def hex_to_rect_plan(h: int, w: int, h1: int, w1: int,
                     interpolation: str = "nearest") -> sampling.SamplePlan:
    key = ("hex_to_rect", h, w, h1, w1, interpolation)
    return _cached_plan(key, lambda: sampling.hex_sample_plan(
        *_linspace_grid(lattice.corner_box("hex_to_rect", h, w), h1, w1),
        h, w, interpolation))


def rect_to_hex_plan(h: int, w: int, h1: int, w1: int,
                     interpolation: str = "nearest",
                     hex_grid_shift: bool = False,
                     nearest_metric: str = "reference") -> sampling.SamplePlan:
    key = ("rect_to_hex", h, w, h1, w1, interpolation, hex_grid_shift,
           nearest_metric)
    return _cached_plan(key, lambda: sampling.rect_sample_plan(
        *_linspace_grid(lattice.corner_box("rect_source", h, w), h1, w1,
                        hex_grid_shift),
        h, w, interpolation, nearest_metric=nearest_metric))


def hexresize_plan(h: int, w: int, h1: int, w1: int,
                   interpolation: str = "linear") -> sampling.SamplePlan:
    key = ("hexresize", h, w, h1, w1, interpolation)
    return _cached_plan(key, lambda: sampling.hex_sample_plan(
        *_linspace_grid(lattice.corner_box("hexresize", h, w), h1, w1),
        h, w, interpolation))


def image_geometric_transformation(img, H=None, interpolation: str = "nearest",
                                   offset: int = 0, device="cuda"):
    """Hex->hex warp by a 3x3 homogeneous (affine) matrix.  ``offset`` is
    accepted for API parity; the sampling assumes an offset-0 source, as
    in the reference."""
    img = _as_image(img, device)
    h, w = img.shape[-2:]
    plan = warp_plan(h, w, H, interpolation)
    return _ref_squeeze(sampling.apply_plan_auto(img, plan), img.ndim)


def hex_to_rect_resample(hex_image, rect_dsize: Optional[Tuple[int, int]] = None,
                         interpolation: str = "nearest", offset: int = 0,
                         device="cuda"):
    """Resample a hex image onto a rect grid spanning its extent."""
    img = _as_image(hex_image, device)
    h, w = img.shape[-2:]
    h1, w1 = (h, w) if rect_dsize is None else tuple(rect_dsize)
    plan = hex_to_rect_plan(h, w, h1, w1, interpolation)
    return _ref_squeeze(sampling.apply_plan_auto(img, plan), img.ndim)


def rect_to_hex_resample(rect_image, hex_dsize: Optional[Tuple[int, int]] = None,
                         interpolation: str = "nearest", offset: int = 0,
                         hex_grid_shift: bool = False,
                         nearest_metric: str = "reference", device="cuda"):
    """Resample a rect image onto a hex-lattice-sized grid.  Like the
    reference, the sample grid is a plain rectangular grid unless
    ``hex_grid_shift=True``."""
    img = _as_image(rect_image, device)
    h, w = img.shape[-2:]
    h1, w1 = (h, w) if hex_dsize is None else tuple(hex_dsize)
    plan = rect_to_hex_plan(h, w, h1, w1, interpolation, hex_grid_shift,
                            nearest_metric)
    return _ref_squeeze(sampling.apply_plan_auto(img, plan), img.ndim)


def hexresize(image, dsize: Tuple[int, int], interpolation: str = "linear",
              offset: int = 0, device="cuda"):
    """Hex->hex rescale to ``dsize`` (plain linspace output lattice, as in
    the reference).  Differentiable in a tensor ``image``.  Each call on the
    card is counted as ``"hexresize"`` (as the resample kernels count their
    launches), and each is traced as the span ``hygrid.hexresize``, its
    gradient as ``hygrid.resample_backward``."""
    img = _as_image(image, device)
    h, w = img.shape[-2:]
    h1, w1 = tuple(dsize)
    with span("hygrid.hexresize", count("hexresize") if img.is_cuda
              else None):
        plan = hexresize_plan(h, w, h1, w1, interpolation)
        out = sampling.apply_plan_auto(img, plan)
    return _ref_squeeze(out, img.ndim)
