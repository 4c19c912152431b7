"""Model input helpers, PyTorch port of ``hexify_batch`` from
``hygrid_tpu/models/train.py`` (the training utilities come with the
training slice)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import geometry, sampling

__all__ = ["hexify_batch"]


def hexify_batch(images: torch.Tensor,
                 hex_size: Optional[Tuple[int, int]] = None,
                 interpolation: str = "bilinear", *,
                 plain: bool = False) -> torch.Tensor:
    """rect (B, C, H, W) -> hex (B, C, h, w) through one resample plan.

    Default target is (H//2, W//2).  A CUDA batch runs the plan-gather
    kernel; ``plain=True`` runs the plain gather-blend on any device.
    """
    h, w = images.shape[-2:]
    if hex_size is None:
        hex_size = (h // 2, w // 2)
    if not plain:
        return geometry.rect_to_hex_resample(images, hex_size, interpolation)
    plan = geometry.rect_to_hex_plan(h, w, *hex_size, interpolation)
    return sampling.apply_plan(images, plan)
