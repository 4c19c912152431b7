"""Hex-aware padding, PyTorch port of ``hygrid_tpu/ops/pad.py``
(``geometry_np.py:683-749``).

Images are channel-last here, ``(H, W)`` or ``(H, W, C)``, unlike the rest
of the package.  Each padded axis is one ``index_select`` with the source
row (column) of every output row (column), taken from numpy's own padding
of the positions ``0..n-1``: ``"reflect"`` (cv2 ``BORDER_REFLECT_101``),
``"symmetric"`` (cv2 ``BORDER_REFLECT``) and ``"edge"`` then follow
``numpy.pad`` exactly, pads as large as the axis included (``F.pad``
refuses those, and has no ``"symmetric"`` mode).  A tensor is padded on
its own device; other input goes to ``device`` first.
"""
from __future__ import annotations

import math
import numbers
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["heximpad", "hex_impad_to_multiple"]

_BORDER = ("constant", "edge", "reflect", "symmetric")


def _as_tensor(img, device) -> torch.Tensor:
    if torch.is_tensor(img):
        return img
    return torch.as_tensor(np.asarray(img), device=device)


def _pad_axis(img: torch.Tensor, axis: int, before: int, after: int,
              mode: str) -> torch.Tensor:
    """Pad one axis by gathering each output position's source position,
    as ``numpy.pad(arange(n), (before, after), mode)`` gives it."""
    if before == 0 and after == 0:
        return img
    src = np.pad(np.arange(img.shape[axis]), (before, after), mode=mode)
    return img.index_select(axis, torch.as_tensor(src, device=img.device))


def _pad_constant(img: torch.Tensor, pad_width, pad_val) -> torch.Tensor:
    (top, bottom), (left, right) = pad_width[:2]
    h, w = img.shape[:2]
    shape = (h + top + bottom, w + left + right) + tuple(img.shape[2:])
    fill = torch.as_tensor(np.asarray(pad_val), device=img.device)
    out = fill.to(img.dtype).expand(shape).clone()
    out[top:top + h, left:left + w] = img
    return out


def heximpad(img, *, shape: Optional[Tuple[int, int]] = None,
             padding: Union[int, tuple, None] = None,
             pad_val: Union[float, List] = 0,
             padding_mode: str = "constant", device="cuda"):
    """Pad a (H, W) or (H, W, C) image with hex-parity-preserving rows.

    The brick-wall layout keeps its parity only when the number of rows
    added on top is even, so an odd top row moves to the bottom: ``top =
    padding[1] - padding[1] % 2``, ``bottom = padding[3] + padding[1] % 2``.
    ``padding`` is cv2-order ``(left, top, right, bottom)``, a 2-tuple
    ``(left/right, top/bottom)`` or one int; ``shape`` pads right and
    bottom up to ``(H, W)``.  ``pad_val`` is a number or, per channel, a
    tuple.
    """
    img = _as_tensor(img, device)
    assert (shape is not None) ^ (padding is not None)
    if shape is not None:
        width = max(shape[1] - img.shape[1], 0)
        height = max(shape[0] - img.shape[0], 0)
        padding = (0, 0, width, height)

    if isinstance(pad_val, tuple):
        assert len(pad_val) == img.shape[-1]
    elif not isinstance(pad_val, numbers.Number):
        raise TypeError("pad_val must be a int or a tuple. "
                        f"But received {type(pad_val)}")

    if isinstance(padding, tuple) and len(padding) in (2, 4):
        if len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
    elif isinstance(padding, numbers.Number):
        padding = (padding, padding, padding, padding)
    else:
        raise ValueError("Padding must be a int or a 2, or 4 element tuple."
                         f"But received {padding}")

    if padding_mode not in _BORDER:
        raise AssertionError(f"unsupported padding_mode {padding_mode!r}")

    top = padding[1] - padding[1] % 2
    bottom = padding[3] + padding[1] % 2
    left, right = padding[0], padding[2]

    if padding_mode == "constant":
        return _pad_constant(img, [(top, bottom), (left, right)], pad_val)
    img = _pad_axis(img, 0, top, bottom, padding_mode)
    return _pad_axis(img, 1, left, right, padding_mode)


def hex_impad_to_multiple(img, divisor: int, pad_val: Union[float, List] = 0,
                          device="cuda"):
    """Pad so each spatial edge is a multiple of ``divisor``
    (``geometry_np.py:734-749``)."""
    pad_h = int(math.ceil(img.shape[0] / divisor)) * divisor
    pad_w = int(math.ceil(img.shape[1] / divisor)) * divisor
    return heximpad(img, shape=(pad_h, pad_w), pad_val=pad_val,
                    device=device)
