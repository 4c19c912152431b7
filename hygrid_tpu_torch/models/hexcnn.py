"""Flagship HexCNN image classifier, PyTorch port of the stage-wise routes
of ``hygrid_tpu/models/hexcnn.py`` (``:120-154``).

Stages of conv layers separated by stride-2 hex max-pools, then a global
average pool and a linear head.  The public input is ``(B, C, H, W)``
brick-wall hex storage with offset 0 (the output of
``rect_to_hex_resample``).  With ``norm`` "GN" or None (and ``use_stack``)
a stage is one :class:`HexConvStack` (conv -> GN -> ReLU) run
channels-last; otherwise ("BN", "SyncBN", "LN", "IN", or
``use_stack=False``) a stage is chained :class:`HexConvModule` bundles on
NCHW, named ``stage{s}_conv{d}`` as in flax's tree.  Their convs are
``HexConv2d(impl="auto")`` and compute in the parameters' float32 whatever
the model's ``dtype`` (``HexConvModule`` passes none to the conv), as in
``hygrid_tpu``; only the head runs in ``dtype``.  The packed-plane route
(``pack_planes`` / ``hex_packed_maxpool2``) is a TPU lane-packing layout
and is not ported; ``hygrid_tpu`` tests it equal to the stage-wise route.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import HexConvStack
from ..nn.modules import HexConvModule

__all__ = ["HexCNN", "hexcnn_small", "hexcnn_tiny"]


class HexCNN(nn.Module):
    """Hex conv stages -> global average pool -> linear head.

    Each stage is ``depth`` conv + norm + ReLU layers followed, except
    after the last, by a stride-2 hex max-pool.

    Args:
        num_classes: classifier width.
        channels: feature width per stage.
        depth: conv layers per stage.
        radius: hex kernel radius.
        norm: "BN" (default, as in ``hygrid_tpu``), "SyncBN", "GN", "LN",
            "IN" or None.
        use_stack: run GN/None stages as :class:`HexConvStack` (else as
            ``HexConvModule`` bundles).
        in_channels: input channels (flax infers them at init; torch
            builds parameters up front).
        dtype: compute dtype; parameters stay float32.
        device / generator: where the parameters live (the card unless
            the caller asks for the CPU) and the generator that initialises
            them.
    """

    def __init__(self, num_classes: int = 10,
                 channels: Sequence[int] = (32, 64, 128), depth: int = 2,
                 radius: int = 2, norm: Optional[str] = "BN",
                 use_stack: bool = True, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.radius, self.dtype = tuple(channels), radius, dtype
        self.depth = depth
        self.stacked = use_stack and norm in ("GN", None)
        if norm == "GN":
            norm_cfg = dict(type="GN", num_groups=8)
        else:
            norm_cfg = dict(type=norm) if norm else None
        cin = in_channels
        for stage, width in enumerate(self.channels):
            if self.stacked:
                self.add_module(f"stage{stage}", HexConvStack(
                    cin, width, depth, hexkernel_radius=radius, norm=norm,
                    num_groups=8, data_format="NHWC", dtype=dtype,
                    device=device, generator=generator))
            else:
                for d in range(depth):
                    self.add_module(f"stage{stage}_conv{d}", HexConvModule(
                        cin, width, 0, radius, padding=radius - 1,
                        norm_cfg=norm_cfg, device=device,
                        generator=generator))
                    cin = width
            cin = width
        self.head = nn.Linear(cin, num_classes, device=device)
        # flax Dense defaults: lecun_normal kernel, zero bias
        std = 1.0 / math.sqrt(cin) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.head.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor, *, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """Logits ``(B, num_classes)`` for hex images ``(B, C, H, W)``;
        ``plain=True`` runs the conv layers' plain versions (the reference
        a kernel run is compared with; the per-module route's convs are
        plain already).  ``train=True`` normalises BN layers with batch
        statistics and updates their running statistics."""
        x = x.to(self.dtype)
        last = len(self.channels) - 1
        fmt = "NHWC" if self.stacked else "NCHW"
        if self.stacked:
            x = x.permute(0, 2, 3, 1).contiguous()
        for stage in range(len(self.channels)):
            if self.stacked:
                x = getattr(self, f"stage{stage}")(x, plain=plain)
            else:
                for d in range(self.depth):
                    x = getattr(self, f"stage{stage}_conv{d}")(x, train=train)
            if stage != last:
                x = F.hex_pool2d(x, "max", kernel_size=2, stride=2,
                                 data_format=fmt).contiguous()
        x = F.hex_global_pool2d(x, "average", data_format=fmt)
        return nn.functional.linear(x.to(self.dtype),
                                    self.head.weight.to(self.dtype),
                                    self.head.bias.to(self.dtype))


def hexcnn_tiny(num_classes: int = 10, **kw) -> HexCNN:
    return HexCNN(num_classes=num_classes, channels=(16, 32), depth=1, **kw)


def hexcnn_small(num_classes: int = 10, **kw) -> HexCNN:
    return HexCNN(num_classes=num_classes, channels=(32, 64, 128), depth=2, **kw)
