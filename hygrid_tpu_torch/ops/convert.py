"""Hex storage-format conversions (type-1 / type-2 packings), PyTorch copy
of ``hygrid_tpu/ops/convert.py`` (``HexFrames.py:417-458``,
``HexImage.py:139-170``).

Type-1 ("double-optimized coordinates"): every hex pixel duplicated x2 along
width; rows are alternately indented by one column; final width ``2W + 1``.
Type-2: type-1 with every row additionally duplicated x2 (visualisation
format).  A tensor stays on its device; other input goes to ``device``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = [
    "heximage_to_type1",
    "heximage_to_type2",
    "type1_to_heximage",
    "type2_to_heximage",
]


def _atleast_4d(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=device)
    while x.ndim < 4:
        x = x[None]
    return x


def heximage_to_type1(input, even_odd_offset: int, device="cuda"):
    """Pack a hex image (B, C, H, W) into type-1 (B, C, H, 2W+1).

    Row ``i`` places hex pixel ``j`` at columns ``2j + q`` and ``2j + 1 + q``
    with ``q = (i + even_odd_offset) % 2``.
    """
    x = _atleast_4d(input, device)
    b, c, h, w = x.shape
    doubled = torch.repeat_interleave(x, 2, dim=3)            # (b,c,h,2w)
    padded = tF.pad(doubled, (1, 1))                          # (b,c,h,2w+2)
    q = (torch.arange(h, device=x.device) + even_odd_offset) % 2
    # a (2w+1) window of the padded row, starting at 0 when the row is
    # indented and at 1 when it is not
    col = torch.arange(2 * w + 1, device=x.device)[None, :] + (q[:, None] ^ 1)
    return torch.gather(padded, 3, col[None, None].expand(b, c, h, 2 * w + 1))


def heximage_to_type2(input, even_odd_offset: int, device="cuda"):
    """Type-2 = type-1 with rows duplicated x2 (``HexFrames.py:446-449``)."""
    t1 = heximage_to_type1(input, even_odd_offset, device)
    return torch.repeat_interleave(t1, 2, dim=2)


def type1_to_heximage(input, even_odd_offset: int, device="cuda"):
    """Inverse pack: take columns ``1::2`` (``HexFrames.py:450-458``).
    Returns ``(heximage, even_odd_offset)`` like the reference."""
    x = _atleast_4d(input, device)
    return x[:, :, :, 1::2], even_odd_offset


def type2_to_heximage(input, even_odd_offset: int, device="cuda"):
    """Inverse of type-2: rows ``::2`` then columns ``1::2``."""
    x = _atleast_4d(input, device)
    return x[:, :, ::2, 1::2], even_odd_offset
