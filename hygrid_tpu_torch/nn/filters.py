"""Fixed hex image filters (Gaussian blur, Laplacian edge, sharpen), PyTorch
port of ``hygrid_tpu/nn/filters.py``.

A radius-2 hex kernel covers the centre and its 6 lattice neighbours, so
the classic filters are 7-tap hex kernels:

    flat tap order (radius 2): [ul, ur, left, CENTER, right, dl, dr]

Filters apply depthwise through :func:`hygrid_tpu_torch.nn.functional.
hex_conv2d` (``impl="direct"``: two masked convs, cuDNN on the card, as
``hygrid_tpu`` leaves them to XLA's conv).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import functional as F

__all__ = [
    "hex_gaussian_kernel",
    "hex_laplacian_kernel",
    "hex_sharpen_kernel",
    "hex_mean_kernel",
    "hex_filter",
    "hex_gaussian_blur",
    "hex_edge_detect",
]


def hex_gaussian_kernel(sigma: float = 1.0) -> np.ndarray:
    """7-tap hex Gaussian: neighbours at lattice distance 1."""
    n = math.exp(-1.0 / (2.0 * sigma * sigma))
    taps = np.array([n, n, n, 1.0, n, n, n], np.float32)
    return taps / taps.sum()


def hex_laplacian_kernel() -> np.ndarray:
    """Hex Laplacian (edge detector): centre minus neighbour mean."""
    s = 1.0 / 6.0
    return np.array([-s, -s, -s, 1.0, -s, -s, -s], np.float32)


def hex_sharpen_kernel(amount: float = 1.0) -> np.ndarray:
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0], np.float32)
    return ident + amount * hex_laplacian_kernel()


def hex_mean_kernel() -> np.ndarray:
    return np.full(7, 1.0 / 7.0, np.float32)


def hex_filter(x, taps, *, even_odd_offset: int = 0, impl: str = "direct"):
    """Apply a flat 7-tap (or any radius) hex kernel depthwise to
    (B, C, H, W), 'same' size.  The taps take a floating input's dtype
    (float32 for other inputs) and its device."""
    x = torch.as_tensor(x)
    while x.ndim < 4:
        x = x[None]
    taps = torch.as_tensor(
        taps, device=x.device,
        dtype=x.dtype if x.dtype.is_floating_point else torch.float32)
    n = taps.shape[-1]
    radius = {1: 1, 7: 2, 19: 3, 37: 4}.get(int(n))
    if radius is None:
        raise ValueError(f"taps length {n} is not a hex kernel size")
    c = x.shape[1]
    kernel = taps.expand((c, 1, n))
    return F.hex_conv2d(x, kernel, even_odd_offset=even_odd_offset,
                        radius=radius, padding=radius - 1, groups=c,
                        impl=impl)


def hex_gaussian_blur(x, sigma: float = 1.0, *, even_odd_offset: int = 0):
    return hex_filter(x, hex_gaussian_kernel(sigma),
                      even_odd_offset=even_odd_offset)


def hex_edge_detect(x, *, even_odd_offset: int = 0):
    return hex_filter(x, hex_laplacian_kernel(),
                      even_odd_offset=even_odd_offset)
