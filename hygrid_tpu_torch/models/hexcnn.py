"""Flagship HexCNN image classifier, PyTorch port of the stage-wise routes
of ``hygrid_tpu/models/hexcnn.py`` (``:120-154``), and its residual
families: :class:`HexConvNeXtBlock`, :class:`HexResBlock` and
:class:`HexResNet` (``:157-244``).

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
from ..utils.profiling import count, span

__all__ = ["HexCNN", "HexConvNeXtBlock", "HexResBlock", "HexResNet",
           "hexcnn_small", "hexcnn_tiny"]


def _dense_init(linear: nn.Linear, generator) -> None:
    """flax ``Dense`` defaults: lecun_normal kernel (a normal truncated at
    two standard deviations), zero bias."""
    std = 1.0 / math.sqrt(linear.in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        linear.bias.zero_()


def _dense(cin: int, cout: int, device, generator) -> nn.Linear:
    """A float32 ``nn.Linear`` with flax ``Dense``'s initialisation."""
    linear = nn.Linear(cin, cout, device=device)
    _dense_init(linear, generator)
    return linear


def _linear(x: torch.Tensor, linear: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)`` on the last axis: input and float32
    parameters cast to ``dtype``."""
    return nn.functional.linear(x.to(dtype), linear.weight.to(dtype),
                                linear.bias.to(dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return nn.functional.gelu(x, approximate="tanh")


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)`` over the last axis: statistics and
    normalisation in float32, the result cast to ``dtype`` (eps 1e-6, the
    module's)."""
    return nn.functional.layer_norm(
        x.float(), norm.normalized_shape, norm.weight, norm.bias,
        norm.eps).to(dtype)


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
        self.head = _dense(cin, num_classes, device, generator)

    def forward(self, x: torch.Tensor, *, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """Logits ``(B, num_classes)`` for hex images ``(B, C, H, W)``;
        ``plain=True`` runs the conv layers' plain versions (the reference
        a kernel run is compared with; the per-module route's convs are
        plain already).  ``train=True`` normalises BN layers with batch
        statistics and updates their running statistics.  Each call is
        counted as ``"forward"`` and traced as the span ``hygrid.forward``,
        identified by that count."""
        with span("hygrid.forward", count("forward")):
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
                        x = getattr(self, f"stage{stage}_conv{d}")(
                            x, train=train)
                if stage != last:
                    x = F.hex_pool2d(x, "max", kernel_size=2, stride=2,
                                     data_format=fmt).contiguous()
            x = F.hex_global_pool2d(x, "average", data_format=fmt)
            return _linear(x, self.head, self.dtype)


def _trunc_normal(shape, std, dtype, device, generator) -> nn.Parameter:
    """flax ``truncated_normal(std)``: a normal truncated at two standard
    deviations."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    return nn.Parameter(t.to(dtype))


class HexConvNeXtBlock(nn.Module):
    """Depthwise hex conv -> LN -> pointwise MLP residual block
    (``hygrid_tpu/models/hexcnn.py:157-183``): the ConvNeXt pattern on the
    hex lattice.

    Parameters: ``dw_kernel`` ``(width, 1, kn)`` stored in ``dtype`` (as
    the reference stores it), ``norm`` (LayerNorm, eps 1e-6), ``fc1``
    ``width -> expand * width`` and ``fc2`` back (flax ``LayerNorm_0``,
    ``Dense_0``, ``Dense_1``; float32, computed in ``dtype``).  The input
    has ``width`` channels (the residual adds it).
    """

    def __init__(self, width: int, radius: int = 3, expand: int = 4,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width, self.radius, self.dtype = width, radius, dtype
        self.dw_kernel = _trunc_normal((width, 1, F.hex_kernel_num(radius)),
                                       0.02, dtype, device, generator)
        self.norm = nn.LayerNorm(width, eps=1e-6, device=device)
        self.fc1 = _dense(width, expand * width, device, generator)
        self.fc2 = _dense(expand * width, width, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, width, H, W)`` -> the same shape, offset 0."""
        residual = x
        x = F.hex_conv2d(x, self.dw_kernel, radius=self.radius,
                         padding=self.radius - 1, groups=self.width)
        x = _layer_norm(x.permute(0, 2, 3, 1), self.norm, self.dtype)
        x = _linear(_gelu(_linear(x, self.fc1, self.dtype)), self.fc2,
                    self.dtype)
        return x.permute(0, 3, 1, 2) + residual


class HexResBlock(nn.Module):
    """Pre-activation residual block (``hygrid_tpu/models/hexcnn.py:186-
    220``): GN -> GELU -> hex conv ``k1`` -> GN -> GELU -> hex conv ``k2``,
    plus the skip (a Dense ``proj`` when the width changes).

    GN has ``gcd(8, C)`` groups, eps 1e-6 and its statistics in float32
    (``gn1``, ``gn2``); the convs are bias-free, ``k1`` ``(width, cin, kn)``
    and ``k2`` ``(width, width, kn)`` stored in ``dtype``, run
    ``impl="direct"`` (cuDNN on the card).
    """

    def __init__(self, in_channels: int, width: int, radius: int = 2,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.radius, self.dtype = radius, dtype
        kn = F.hex_kernel_num(radius)
        self.gn1 = nn.GroupNorm(math.gcd(8, in_channels), in_channels,
                                eps=1e-6, device=device)
        self.k1 = _trunc_normal((width, in_channels, kn), 0.05, dtype, device,
                                generator)
        self.gn2 = nn.GroupNorm(math.gcd(8, width), width, eps=1e-6,
                                device=device)
        self.k2 = _trunc_normal((width, width, kn), 0.05, dtype, device,
                                generator)
        self.proj = (_dense(in_channels, width, device, generator)
                     if in_channels != width else None)

    def _gn_gelu(self, x, gn):
        x = nn.functional.group_norm(x.float(), gn.num_groups, gn.weight,
                                     gn.bias, gn.eps)
        return _gelu(x.to(self.dtype))

    def _conv(self, x, kernel):
        return F.hex_conv2d(x, kernel, radius=self.radius,
                            padding=self.radius - 1, impl="direct")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, in_channels, H, W)`` -> ``(B, width, H, W)``."""
        h = self._conv(self._gn_gelu(x, self.gn1), self.k1)
        h = self._conv(self._gn_gelu(h, self.gn2), self.k2)
        if self.proj is not None:
            x = _linear(x.permute(0, 2, 3, 1), self.proj,
                        self.dtype).permute(0, 3, 1, 2)
        return x + h


class HexResNet(nn.Module):
    """Residual hex backbone and classifier (``hygrid_tpu/models/hexcnn.py:
    223-244``): stages of :class:`HexResBlock` named ``s{i}b{j}``, a
    stride-2 hex max-pool between stages, a global average pool and the
    Dense ``head``.

    ``in_channels``: the input's channels (flax infers them at init).
    ``device`` / ``generator``: where the parameters live (the card unless
    the caller asks for the CPU) and what initialises them.
    """

    def __init__(self, num_classes: int = 10,
                 widths: Sequence[int] = (32, 64, 128),
                 blocks_per_stage: int = 2, radius: int = 2,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths, self.dtype = tuple(widths), dtype
        self.blocks_per_stage = blocks_per_stage
        cin = in_channels
        for si, width in enumerate(self.widths):
            for bi in range(blocks_per_stage):
                self.add_module(f"s{si}b{bi}", HexResBlock(
                    cin, width, radius, dtype, device, generator))
                cin = width
        self.head = _dense(cin, num_classes, device, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits ``(B, num_classes)`` for hex images ``(B, C, H, W)``;
        ``train`` is the reference's flag (no layer differs in training)."""
        x = x.to(self.dtype)
        last = len(self.widths) - 1
        for si in range(len(self.widths)):
            for bi in range(self.blocks_per_stage):
                x = getattr(self, f"s{si}b{bi}")(x)
            if si != last:
                x = F.hex_pool2d(x, "max", kernel_size=2, stride=2)
        return _linear(F.hex_global_pool2d(x, "average"), self.head,
                       self.dtype)


def hexcnn_tiny(num_classes: int = 10, **kw) -> HexCNN:
    return HexCNN(num_classes=num_classes, channels=(16, 32), depth=1, **kw)


def hexcnn_small(num_classes: int = 10, **kw) -> HexCNN:
    return HexCNN(num_classes=num_classes, channels=(32, 64, 128), depth=2, **kw)
