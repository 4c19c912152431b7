"""Streaming tiled resampling for rasters larger than device memory,
PyTorch port of ``hygrid_tpu/ops/tiled.py``.

Every resample is a data-independent gather plan, so a tile of output rows
needs only the contiguous band of input rows its indices touch.  The input
stays in host RAM (numpy or ``np.memmap``); each tile's band is copied to
the device in its own dtype and cast there to float32, then resampled by
a sub-plan of the whole plan (:meth:`SamplePlan.row_slice`, built per
call as the reference builds it), and the tiles come back as numpy.

The band runs through :func:`~hygrid_tpu_torch.ops.sampling.apply_plan_auto`
(``plan_gather`` on the card), not the plain ``apply_plan`` the reference
calls here: on the card ``apply_plan`` is only the kernel's plain version.
A rect->hex bilinear sub-plan keeps its rows' slice of the plan's float64
factors, so the kernel rebuilds its weights as for the whole plan
(``kernels/resample.py::gather_tables`` checks them bit for bit).  Floating
outputs are float32, as the reference's integer blends are; an
exact-select plan keeps an integer source's dtype, through float32 where
its values are exact there (at most 16 bits), else by the plain gather.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import geometry, sampling

__all__ = ["tiled_resample", "tiled_rect_to_hex", "tiled_hexresize"]


def _band_dtype(dtype: np.dtype, exact_select: bool):
    """The dtype a band is resampled in, and the dtype the tile returns."""
    if dtype.kind in "iub" and exact_select:
        if dtype.itemsize <= 2:
            return torch.float32, dtype
        return None, dtype            # the plain gather keeps it exactly
    return torch.float32, np.dtype(np.float32)


def _tiled_apply(plan: sampling.SamplePlan, image: np.ndarray,
                 tile_rows: int, device) -> np.ndarray:
    work, out_dtype = _band_dtype(image.dtype, plan.exact_select)
    out_tiles = []
    h1 = plan.out_shape[0]
    for r0 in range(0, h1, tile_rows):
        lo, hi, sub = plan.row_slice(r0, min(r0 + tile_rows, h1))
        band = torch.from_numpy(np.ascontiguousarray(
            image[..., lo:hi + 1, :])).to(device)
        if work is None:
            out = sampling.apply_plan(band, sub)
        else:
            out = sampling.apply_plan_auto(band.to(work), sub)
        out_tiles.append(out.cpu().numpy().astype(out_dtype, copy=False))
    return np.concatenate(out_tiles, axis=-2)


def _as_source(image) -> np.ndarray:
    image = np.asarray(image)
    return image[None] if image.ndim == 2 else image


def tiled_rect_to_hex(image, hex_dsize: Tuple[int, int],
                      interpolation: str = "bilinear",
                      tile_rows: int = 2048,
                      nearest_metric: str = "reference",
                      device="cuda") -> np.ndarray:
    """rect -> hex for host-resident giant rasters, streamed in output-row
    tiles.  The numerics of
    :func:`hygrid_tpu_torch.ops.geometry.rect_to_hex_resample` on a
    float32 image."""
    image = _as_source(image)
    h, w = image.shape[-2:]
    plan = geometry.rect_to_hex_plan(h, w, *hex_dsize, interpolation,
                                     nearest_metric=nearest_metric)
    return _tiled_apply(plan, image, tile_rows, device)


def tiled_hexresize(image, dsize: Tuple[int, int],
                    interpolation: str = "linear",
                    tile_rows: int = 2048, device="cuda") -> np.ndarray:
    """hex -> hex resize for giant rasters, streamed in output-row tiles."""
    image = _as_source(image)
    h, w = image.shape[-2:]
    plan = geometry.hexresize_plan(h, w, *dsize, interpolation)
    return _tiled_apply(plan, image, tile_rows, device)


def tiled_resample(image, kind: str, dsize: Tuple[int, int],
                   interpolation: Optional[str] = None,
                   tile_rows: int = 2048, device="cuda") -> np.ndarray:
    """Dispatch by kind: 'rect_to_hex' | 'hexresize' | 'hex_to_rect'."""
    if kind == "rect_to_hex":
        return tiled_rect_to_hex(image, dsize, interpolation or "bilinear",
                                 tile_rows, device=device)
    if kind == "hexresize":
        return tiled_hexresize(image, dsize, interpolation or "linear",
                               tile_rows, device=device)
    if kind == "hex_to_rect":
        image = _as_source(image)
        h, w = image.shape[-2:]
        plan = geometry.hex_to_rect_plan(h, w, *dsize,
                                         interpolation or "linear")
        return _tiled_apply(plan, image, tile_rows, device)
    raise ValueError(f"unknown kind {kind!r}")
