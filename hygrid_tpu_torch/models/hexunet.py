"""HexUNet dense-prediction model family, PyTorch port of the stage-wise
route of ``hygrid_tpu/models/hexunet.py`` (``:217-272``).

Encoder: conv(+norm)(+ReLU) stages and stride-2 hex max-pools; decoder: a
transposed hex conv (or a hex pixel shuffle) upsamples, crops or pads to the
skip's size and joins the skip; output: per-cell class logits at the input
hex resolution, ``(B, num_classes, h, w)``.

With ``norm`` "GN" or None (and ``use_stack``) each stage is one
:class:`HexConvStack`, and each decoder stage is its skip-join form
(``forward(x, extra=skip)``): layer 0 runs the split layer, ``conv(up,
Ka) + conv(skip, Kb)`` without building the 2W-channel concatenation (on
the card the split mode of ``csrc/hex_conv_layer.cu``; its backward the
dgrad and dW kernels on each input's part, so the model trains).  This
route runs channels-last from the first stage to the head.  Other
norms ("BN", "LN", "IN"; BN in eval unless ``train=True``) chain
:class:`HexConvModule` bundles ``enc{i}_conv{d}`` / ``dec{i}_conv{d}`` on
NCHW, their convs in the parameters' float32 as in ``hygrid_tpu``.

The reference's packed-plane encoder (``hexunet.py:164-216``) is a TPU
lane-packing layout and is not ported; ``hygrid_tpu`` tests it equal to the
stage-wise route.  Its ``stack_min_cells`` gate is a TPU threshold: the
port neither takes nor needs it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn import experimental as E
from ..nn import functional as F
from ..nn.layers import HexConvStack, _kaiming_hex_init
from ..nn.modules import HexConvModule
from ..utils.profiling import count, span
from .hexcnn import _dense_init

__all__ = ["HexUNet", "HexConvTranspose2d", "HexPixelShuffleUpsample"]


class HexConvTranspose2d(nn.Module):
    """Transposed hex conv layer (``hygrid_tpu/models/hexunet.py:25-65``,
    archive codes:129-274) over :func:`E.hex_conv_transpose2d`.

    Parameters: ``kernel`` ``(out_channels, in_channels // groups, kn)``,
    uniform in ``+-1/sqrt(fan_in)``, and ``bias`` (zeros) with
    ``use_bias``.  Both are cast down to the compute dtype (``dtype``, or
    the input's) before the op, so float32 parameters do not lift a
    bfloat16 input to float32.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 even_odd_offset: int, hexkernel_radius: int,
                 stride: int = 1, groups: int = 1, use_bias: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 dtype: Optional[torch.dtype] = None,
                 data_format: str = "NCHW", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.even_odd_offset, self.hexkernel_radius = (even_odd_offset,
                                                       hexkernel_radius)
        self.stride, self.groups = stride, groups
        self.dtype, self.data_format = dtype, data_format
        kn = F.hex_kernel_num(hexkernel_radius)
        fkw = dict(device=device, dtype=param_dtype)
        self.kernel = nn.Parameter(_kaiming_hex_init(
            torch.empty((out_channels, in_channels // groups, kn), **fkw),
            (in_channels // groups) * kn, generator))
        self.bias = (nn.Parameter(torch.zeros((out_channels,), **fkw))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(cdt)
        return E.hex_conv_transpose2d(
            x, self.kernel.to(cdt), bias,
            even_odd_offset=self.even_odd_offset,
            radius=self.hexkernel_radius, stride=self.stride,
            groups=self.groups, data_format=self.data_format)


class HexPixelShuffleUpsample(nn.Module):
    """1x1 expand (``expand``, flax's ``Dense_0``) then
    :func:`E.hex_pixel_shuffle` (``hygrid_tpu/models/hexunet.py:68-83``).
    Takes and returns NCHW; the expand computes in ``dtype`` (None: the
    input's)."""

    def __init__(self, in_channels: int, channels: int, factor: int = 2,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.factor, self.dtype = factor, dtype
        self.expand = nn.Linear(in_channels, channels * factor ** 2,
                                device=device)
        _dense_init(self.expand, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        y = nn.functional.linear(x.permute(0, 2, 3, 1).to(cdt),
                                 self.expand.weight.to(cdt),
                                 self.expand.bias.to(cdt))
        return E.hex_pixel_shuffle(y.permute(0, 3, 1, 2), self.factor)


def _crop_or_pad_to(x: torch.Tensor, target_hw, nhwc: bool = False
                    ) -> torch.Tensor:
    """Crop the spatial dims to ``target_hw``, then zero-pad them up to it
    at the bottom and right (``hygrid_tpu/models/hexunet.py:86-98``)."""
    th, tw = target_hw
    ha, wa = (1, 2) if nhwc else (2, 3)
    x = x.narrow(ha, 0, min(x.shape[ha], th)).narrow(wa, 0,
                                                     min(x.shape[wa], tw))
    ph, pw = th - x.shape[ha], tw - x.shape[wa]
    if ph or pw:
        pad = (0, 0, 0, pw, 0, ph) if nhwc else (0, pw, 0, ph)
        x = nn.functional.pad(x, pad)
    return x


class HexUNet(nn.Module):
    """Encoder/decoder over the hex lattice with skip connections.

    Args:
        num_classes: logits per cell.
        widths: feature width per encoder stage (the decoder mirrors them).
        radius: hex kernel radius.
        depth: conv layers per stage.
        norm: "GN" (default), None, or "BN" / "LN" / "IN" (module bundles).
        upsample: "transpose" (:class:`HexConvTranspose2d`, stride 2) or
            "pixelshuffle" (:class:`HexPixelShuffleUpsample`).
        use_stack: run GN/None stages as :class:`HexConvStack`.
        dtype: compute dtype; parameters stay float32.
        in_channels: input channels (flax infers them at init; torch builds
            parameters up front).
        device / generator: where the parameters live (the card unless the
            caller asks for the CPU) and what initialises them.

    Submodules carry flax's names (``enc{i}``, ``up{i}``, ``dec{i}``,
    ``head``; ``enc{i}_conv{d}`` / ``dec{i}_conv{d}`` bundles for the other
    norms), so that
    :func:`hygrid_tpu_torch.utils.params.hexunet_state_dict_from_flax` maps
    ``hygrid_tpu.models.HexUNet``'s variables one to one.
    """

    def __init__(self, num_classes: int, widths: Sequence[int] = (32, 64, 128),
                 radius: int = 2, depth: int = 1, norm: Optional[str] = "GN",
                 upsample: str = "transpose", use_stack: bool = True,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if upsample not in ("transpose", "pixelshuffle"):
            raise ValueError(f"upsample must be 'transpose' or "
                             f"'pixelshuffle', got {upsample!r}")
        self.widths, self.radius, self.depth = tuple(widths), radius, depth
        self.norm, self.upsample, self.dtype = norm, upsample, dtype
        self.stacked = use_stack and norm in ("GN", None)
        if norm == "GN":
            norm_cfg = dict(type="GN", num_groups=8)
        else:
            norm_cfg = dict(type=norm) if norm else None
        kw = dict(device=device, generator=generator)

        def stage(name, c_in, width):
            if self.stacked and c_in <= width:
                self.add_module(name, HexConvStack(
                    c_in, width, depth, hexkernel_radius=radius, norm=norm,
                    num_groups=8, data_format="NHWC", dtype=dtype, **kw))
                return
            for d in range(depth):
                self.add_module(f"{name}_conv{d}", HexConvModule(
                    c_in if d == 0 else width, width, 0, radius,
                    padding=radius - 1, norm_cfg=norm_cfg, **kw))

        cin = in_channels
        for i, width in enumerate(self.widths):
            stage(f"enc{i}", cin, width)
            cin = width
        for i, width in enumerate(reversed(self.widths[:-1])):
            if upsample == "transpose":
                self.add_module(f"up{i}", HexConvTranspose2d(
                    cin, width, 0, radius, stride=2,
                    data_format="NHWC" if self.stacked else "NCHW", **kw))
            else:
                self.add_module(f"up{i}", HexPixelShuffleUpsample(
                    cin, width, 2, **kw))
            if self.stacked:
                self.add_module(f"dec{i}", HexConvStack(
                    2 * width, width, depth, hexkernel_radius=radius,
                    norm=norm, num_groups=8, data_format="NHWC", dtype=dtype,
                    **kw))
            else:
                stage(f"dec{i}", 2 * width, width)
            cin = width
        self.head = nn.Linear(cin, num_classes, device=device)
        _dense_init(self.head, generator)

    def _stage(self, v, name, plain, train):
        """One encoder stage (or an unstacked decoder stage) on ``v``, in
        the route's layout (NHWC when stacked)."""
        if hasattr(self, name):
            return getattr(self, name)(v, plain=plain)
        if self.stacked:    # c_in > width: module bundles run NCHW
            v = v.permute(0, 3, 1, 2)
        for d in range(self.depth):
            v = getattr(self, f"{name}_conv{d}")(v, train=train)
        return v.permute(0, 2, 3, 1).contiguous() if self.stacked else v

    def forward(self, x: torch.Tensor, *, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """Per-cell logits ``(B, num_classes, h, w)`` for hex images ``(B,
        C, h, w)``.  ``plain=True`` runs the conv stacks' plain versions
        (the reference a kernel run is compared with); ``train=True``
        normalises BN bundles with batch statistics.  Differentiable in
        the input and every parameter on both routes.  Each call is counted
        as ``"forward"`` and traced as the span ``hygrid.forward``,
        identified by that count."""
        with span("hygrid.forward", count("forward")):
            x = x.to(self.dtype)
            nhwc = self.stacked
            fmt = "NHWC" if nhwc else "NCHW"
            if nhwc:
                x = x.permute(0, 2, 3, 1).contiguous()
            skips = []
            last = len(self.widths) - 1
            for i in range(len(self.widths)):
                x = self._stage(x, f"enc{i}", plain, train)
                if i != last:
                    skips.append(x)
                    x = F.hex_pool2d(x, "max", kernel_size=2, stride=2,
                                     data_format=fmt).contiguous()
            for i in range(len(self.widths) - 1):
                up = getattr(self, f"up{i}")
                if isinstance(up, HexPixelShuffleUpsample) and nhwc:
                    x = up(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                else:
                    x = up(x)
                skip = skips.pop()
                x = _crop_or_pad_to(x, skip.shape[1:3] if nhwc
                                    else skip.shape[-2:], nhwc)
                if nhwc:
                    x = getattr(self, f"dec{i}")(x, extra=skip, plain=plain)
                else:
                    x = self._stage(torch.cat([x, skip], dim=1), f"dec{i}",
                                    plain, train)
            if not nhwc:
                x = x.permute(0, 2, 3, 1)
            x = nn.functional.linear(x.to(self.dtype),
                                     self.head.weight.to(self.dtype),
                                     self.head.bias.to(self.dtype))
            return x.permute(0, 3, 1, 2)
