"""Hexagon-mosaic rasteriser (layer L5), PyTorch port of
``hygrid_tpu/viz/render.py``.

The reference viewer's fragment shader (nearest hex centre per output
pixel) is a data-independent map from output pixel to source texel, so it
is a precomputed exact-select gather plan: one resample renders the whole
frame, all channels, on the device.  The plan is K=1 with a 0/1 mask and
a constant column stride (``den`` = the zoom), so on the card it runs the
shift resampler (``kernels/resample_shift.py``).

Pan, zoom and hierarchy are pure functions of the view state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.sampling import SamplePlan, apply_plan_auto

__all__ = ["ViewState", "mosaic_plan", "render_mosaic"]


@dataclasses.dataclass(frozen=True)
class ViewState:
    """Pure view state: pan offsets in clip space, zoom scale, mosaic
    hierarchy level (the shader's ``hexmosaicSizeRatio = 2**-hierarchy``)."""

    dx: float = 0.0
    dy: float = 0.0
    scale: float = 1.0
    hierarchy: int = 0

    def pan(self, dx: float, dy: float) -> "ViewState":
        return dataclasses.replace(self, dx=self.dx + dx, dy=self.dy + dy)

    def zoom(self, factor: float) -> "ViewState":
        return dataclasses.replace(self, scale=self.scale * factor)

    def coarser(self, levels: int = 1) -> "ViewState":
        return dataclasses.replace(self, hierarchy=self.hierarchy + levels)


def mosaic_plan(tex_h: int, tex_w: int, out_h: int, out_w: int,
                even_odd_offset: int = 0, view: Optional[ViewState] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel source texel indices + validity mask (numpy copy of
    ``hygrid_tpu.viz.render.mosaic_plan``, bit-equal).

    Half-cell boxes of size (TB=0.5, TR=1) * 2^-hierarchy, two diagonal
    candidate centres picked by a parity test, nearer-by-squared-distance
    wins; the winning centre de-skews to texel coordinates by GLSL's
    truncating integer division; clamp-to-border sampling is a zero mask.

    Returns ``(flat_idx int32 (out_h, out_w), mask float32 (out_h, out_w))``.
    """
    view = view or ViewState()
    ratio = float(2.0 ** (-view.hierarchy))
    tb, tr = 0.5 * ratio, 1.0 * ratio

    sizex = tex_w + 0.5
    sizey = tex_h + 1.0

    jj, ii = np.meshgrid(np.arange(out_w), np.arange(out_h))
    u = (jj + 0.5) / out_w
    v = (ii + 0.5) / out_h
    # pan/zoom transform the quad in clip space; equivalently transform uv
    u = (u - 0.5) / view.scale + 0.5 + view.dx
    v = (v - 0.5) / view.scale + 0.5 + view.dy

    x = u * sizex
    y = v * sizey

    wx = np.trunc(x / tb).astype(np.int64)
    wy = np.trunc(y / tr).astype(np.int64)

    same_parity = ((wx + even_odd_offset) & 1) == (wy & 1)
    v1x = np.where(same_parity, tb * wx, tb * wx)
    v1y = np.where(same_parity, tr * wy, tr * (wy + 1))
    v2x = np.where(same_parity, tb * (wx + 1), tb * (wx + 1))
    v2y = np.where(same_parity, tr * (wy + 1), tr * wy)

    s1 = (v1x - x) ** 2 + (v1y - y) ** 2
    s2 = (v2x - x) ** 2 + (v2y - y) ** 2
    pick1 = s1 < s2
    cx = np.where(pick1, v1x, v2x)
    cy = np.where(pick1, v1y, v2y)

    vx = np.trunc(cx / 0.5).astype(np.int64)
    vy = np.trunc(cy / 1.0).astype(np.int64)

    # GLSL integer division truncates toward zero
    num = vx - 1 - (vy + 1 + even_odd_offset) % 2
    sx = np.trunc(num / 2).astype(np.float64) + 0.5
    sy = vy - 0.5

    # texture2D with unnormalised coords, GL_NEAREST region semantics:
    # texel index = floor(coord * size)
    tj = np.floor(sx).astype(np.int64)
    ti = np.floor(sy).astype(np.int64)
    mask = ((ti >= 0) & (ti < tex_h) & (tj >= 0) & (tj < tex_w))
    flat = (np.clip(ti, 0, tex_h - 1) * tex_w
            + np.clip(tj, 0, tex_w - 1)).astype(np.int32)
    return flat, mask.astype(np.float32)


_PLAN_CACHE: dict = {}
# A 4K view holds its plan (66 MB) and shift geometry (199 MB) on the host
# and the geometry's weight table (199 MB) on the card; both live exactly
# as long as the plan, so this one cap bounds them.
_PLAN_CACHE_MAX = 4


def _mosaic_sample_plan(h, w, out_h, out_w, even_odd_offset, view
                        ) -> SamplePlan:
    """The mosaic as an exact-select :class:`SamplePlan`, cached by view,
    so that the plan's shift decomposition and device tables (kept on the
    plan) are paid once per view."""
    key = (h, w, out_h, out_w, even_odd_offset, view)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        flat, mask = mosaic_plan(h, w, out_h, out_w, even_odd_offset, view)
        plan = SamplePlan(flat[None], mask[None], (h, w), (out_h, out_w),
                          exact_select=True)
        _PLAN_CACHE[key] = plan
    return plan


def render_mosaic(hex_image, out_size: Tuple[int, int],
                  even_odd_offset: int = 0, view: Optional[ViewState] = None,
                  background: float = 0.0, device="cuda"):
    """Render a hex image (C, H, W) as a true hexagon mosaic (C, out_h, out_w).

    A tensor renders on its own device; a numpy array is moved to
    ``device`` first.  float32 frames are sampled in bfloat16 and returned
    as float32; 8-bit integer frames go through bfloat16 and back
    bit-exactly; ``background`` fills the pixels outside the texture.
    """
    img = (hex_image if torch.is_tensor(hex_image)
           else torch.as_tensor(np.asarray(hex_image), device=device))
    if img.ndim == 2:
        img = img[None]
    h, w = img.shape[-2:]
    out_h, out_w = out_size
    plan = _mosaic_sample_plan(h, w, out_h, out_w, even_odd_offset, view)
    f32 = img.dtype == torch.float32
    frame = apply_plan_auto(img.to(torch.bfloat16) if f32 else img, plan)
    if f32:
        frame = frame.float()
    if background:
        mask = plan.tensors(img.device)[1].reshape(out_h, out_w)
        frame = (frame.float() + background * (1 - mask)).to(frame.dtype)
    return frame
