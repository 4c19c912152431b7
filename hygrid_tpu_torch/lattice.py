"""Hex-lattice coordinate conventions (layer L1).

A numpy-only copy of ``hygrid_tpu/lattice.py``: ``hygrid_tpu`` imports JAX
when its package is imported, so the PyTorch port carries its own copy
(held equal to the original by ``tests/test_torch_lattice.py``).  The port
builds every plan in float64 numpy, so only ``xp=numpy`` is used here.

The reference library (Tesla-Albert/Hybrid-Grid-for-Hexagonal-and-Rectangular-
Image-Processing, "HyGrid") never gives these formulas a home: the same
coordinate math is duplicated across ``geometry_np.py:29-128``,
``geometry_torch.py:29-128``, ``geometry.py:19-50`` and ``HexFrames.py:417-458``.
This module is the single source of truth for the rebuilt framework.

Storage scheme ("brick wall" offset layout)
-------------------------------------------
A hex image is a dense array ``(bands, H, W)``.  Row ``i`` of hex cells is
horizontally shifted by half a cell when ``(i + even_odd_offset)`` is odd
(cf. ``geometry_np.py:44``: rows ``(1-offset)::2`` receive the ``+0.5`` shift).

Cell-center Cartesian coordinates (origin at the image center, x = row
direction pointing down, y = column direction pointing right), from
``geometry_np.py:39-46``::

    x(i)    = i + 0.5 - H/2
    y(i, j) = j + 0.5 + 0.5*[(i + offset) % 2 == 1] - (W + 0.5)/2

Affine (oblique) index
----------------------
To locate which lattice cell a continuous point falls in, HyGrid uses a
skewed index (``geometry_np.py:109-110``; identically in the CUDA kernel at
``geometry.py:28-29``)::

    i_ = x + (H - 1)/2
    j_ = 0.5*i_ + y + (W - 0.5)/2

For an offset-0 image the cell at storage index ``(i, j)`` has affine index
``(i, j + floor((i+1)/2))``.  The reference's sampling math hard-codes the
``offset = 0`` convention (its ``offset`` argument only feeds a dead
``imgcoor`` array, ``geometry_np.py:29-46`` — never used afterwards); we
reproduce that behaviour for parity and expose the honest formula separately.

All functions here are ``xp``-polymorphic: pass ``xp=numpy`` for trace-time
(plan) computation in float64, or ``xp=jax.numpy`` for fully on-device traced
computation.  Integer casts deliberately use *truncation toward zero*
(`astype(int)` semantics in both numpy and XLA) to match the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "HexSpec",
    "row_is_shifted",
    "cell_centers",
    "affine_index",
    "hex_neighbors",
    "triangle_weights_linear",
    "triangle_select_nearest",
    "corner_box",
]


@dataclasses.dataclass(frozen=True)
class HexSpec:
    """Static description of a hex image's lattice.

    Attributes:
        height: number of hex rows (H).
        width: number of hex cells per row (W).
        even_odd_offset: 0 if even rows are unshifted, 1 if odd rows are.
    """

    height: int
    width: int
    even_odd_offset: int = 0

    def padded(self, padding: int) -> "HexSpec":
        """Spec after symmetric padding; parity flips per ``HexFrames.py:44``:
        ``padded_offset = (offset + padding) % 2``."""
        return HexSpec(
            self.height + 2 * padding,
            self.width + 2 * padding,
            (self.even_odd_offset + padding) % 2,
        )


def row_is_shifted(i, offset: int, xp=np):
    """True where storage row ``i`` carries the +0.5 column shift."""
    return (i + offset) % 2 == 1


def cell_centers(h: int, w: int, offset: int = 0, xp=np):
    """Cartesian centers of every hex cell. Returns ``(x, y)`` of shape (h, w).

    Mirrors ``geometry_np.py:29-46``.
    """
    i = xp.arange(h, dtype=xp.float64 if xp is np else xp.float32)
    j = xp.arange(w, dtype=xp.float64 if xp is np else xp.float32)
    ii, jj = xp.meshgrid(i, j, indexing="ij")
    x = ii + 0.5 - h / 2.0
    y = jj + 0.5 + 0.5 * row_is_shifted(ii, offset, xp) - (w + 0.5) / 2.0
    return x, y


def affine_index(x, y, h: int, w: int):
    """Continuous affine (oblique) index of Cartesian points.

    Mirrors ``geometry_np.py:109-110``. Works for numpy or jnp arrays.
    """
    i_ = x + (h - 1) * 0.5
    j_ = 0.5 * i_ + y + (w - 0.5) * 0.5
    return i_, j_


def _trunc_int(a, xp):
    """``astype(int)`` semantics: truncate toward zero."""
    if xp is np:
        return a.astype(np.int64)
    return a.astype("int32")  # XLA f->i conversion truncates toward zero


def _trunc_div2(a, xp):
    """Reference idiom ``(a / 2).astype(int)``: float divide then truncate
    toward zero (NOT floor). Cf. ``geometry_np.py:122-128``."""
    return _trunc_int(a / 2.0, xp)


def hex_neighbors(i_n, j_n, xp=np):
    """Storage indices of the 4 candidate neighbours around affine cell
    ``(i_n, j_n)`` assuming an offset-0 lattice.

    Mirrors ``geometry_np.py:121-128`` (the affine->offset de-skew).
    Returns ``((i_1, j_1), (i_2, j_2), (i_3, j_3), (i_4, j_4))`` where
    1 = same-row left, 2 = next-row left, 3 = same-row right,
    4 = next-row right.
    """
    i_1 = i_n
    j_1 = j_n - _trunc_div2(i_n + 1, xp)
    i_2 = i_n + 1
    j_2 = j_n - _trunc_div2(i_n + 2, xp)
    i_3 = i_n
    j_3 = j_n + 1 - _trunc_div2(i_n + 1, xp)
    i_4 = i_n + 1
    j_4 = j_n + 1 - _trunc_div2(i_n + 2, xp)
    return (i_1, j_1), (i_2, j_2), (i_3, j_3), (i_4, j_4)


def triangle_vertices(i_n, j_n, i_f, j_f, h: int, w: int, xp=np):
    """Cartesian coordinates of the 3 interpolation vertices.

    The sample point lies in the upper triangle (vertex 2 from the next row)
    when ``i_f > j_f`` else the lower one (vertex 3 from the same row);
    mirrors ``geometry_np.py:131, 159-164``.

    Returns ``(flag, (p1_x, p1_y), (p2_x, p2_y), (p3_x, p3_y))`` where
    ``flag`` is the up/down boolean array.
    """
    flag = i_f > j_f
    flag_f = flag.astype(i_f.dtype) if hasattr(flag, "astype") else flag
    p1_x = i_n - (h - 1) / 2.0
    p1_y = j_n - i_n / 2.0 - (w - 0.5) / 2.0
    p2_x = (i_n + flag_f) - (h - 1) / 2.0
    p2_y = (j_n + 1 - flag_f) - (i_n + flag_f) / 2.0 - (w - 0.5) / 2.0
    p3_x = (i_n + 1) - (h - 1) / 2.0
    p3_y = (j_n + 1) - (i_n + 1) / 2.0 - (w - 0.5) / 2.0
    return flag, (p1_x, p1_y), (p2_x, p2_y), (p3_x, p3_y)


def triangle_weights_linear(x, y, p1, p2, p3, xp=np):
    """Barycentric weights over the three vertices.

    Mirrors ``geometry_np.py:180-187``: weights are opposing sub-triangle
    areas, alpha belongs to p1 via S1 = area(x, p2, p3), etc.
    """
    (p1_x, p1_y), (p2_x, p2_y), (p3_x, p3_y) = p1, p2, p3
    s1 = 0.5 * xp.abs((x - p2_x) * (y - p3_y) - (y - p2_y) * (x - p3_x))
    s2 = 0.5 * xp.abs((x - p1_x) * (y - p3_y) - (y - p1_y) * (x - p3_x))
    s3 = 0.5 * xp.abs((x - p1_x) * (y - p2_y) - (y - p1_y) * (x - p2_x))
    total = s1 + s2 + s3
    return s1 / total, s2 / total, s3 / total


def triangle_select_nearest(x, y, p1, p2, p3, xp=np):
    """Index (0/1/2) of the nearest of the three vertices by squared
    Euclidean distance, first-minimum tie-breaking.

    The reference's own 'nearest' branch in the hex-source resamplers is
    broken (``min_values, min_indices = np.min(d, axis=0)`` raises at
    ``geometry_np.py:172,339,664``); we implement the evident intent with
    ``argmin`` (documented divergence, SURVEY.md section 4 item 3).
    """
    (p1_x, p1_y), (p2_x, p2_y), (p3_x, p3_y) = p1, p2, p3
    d1 = (x - p1_x) ** 2 + (y - p1_y) ** 2
    d2 = (x - p2_x) ** 2 + (y - p2_y) ** 2
    d3 = (x - p3_x) ** 2 + (y - p3_y) ** 2
    d = xp.stack((d1, d2, d3), axis=0)
    return xp.argmin(d, axis=0)


def corner_box(kind: str, h: int, w: int) -> Tuple[float, float, float, float]:
    """Image corner boxes used to derive output extents.

    Each reference function uses a slightly different box — the constants ARE
    the spec (SURVEY.md section 7.3):

    * ``"warp"``: ``geometry_np.py:56-59`` — half-cell inset on both axes.
    * ``"hex_to_rect"``: ``geometry_np.py:236-239`` — 0.75 inset on y.
    * ``"hexresize"``: ``geometry_np.py:560-563`` — same as warp.
    * ``"rect_source"``: ``geometry_np.py:401-404`` — rect image outer box,
      widened by 0.5 on y.

    Returns ``(h_inf, h_sup, w_inf, w_sup)``.
    """
    if kind in ("warp", "hexresize"):
        return (-(h / 2 - 0.5), h / 2 - 0.5, -((w + 0.5) / 2 - 0.5), (w + 0.5) / 2 - 0.5)
    if kind == "hex_to_rect":
        return (-(h / 2 - 0.5), h / 2 - 0.5, -((w + 0.5) / 2 - 0.75), (w + 0.5) / 2 - 0.75)
    if kind == "rect_source":
        return (-(h / 2), h / 2, -(w / 2 + 0.5), w / 2 + 0.5)
    raise ValueError(f"unknown corner box kind: {kind!r}")
