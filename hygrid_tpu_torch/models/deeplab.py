"""HexDeepLabV3: DeepLabv3 at output stride 16 (Chen et al. 2017,
arXiv:1706.05587, sections 3.3 and 4) on a ResNet-50-style bottleneck
backbone (He et al. 2015, arXiv:1512.03385, Table 1) with GroupNorm in
place of BatchNorm (Wu and He 2018, arXiv:1803.08494), on the hex lattice.

The backbone is a stride-2 stem conv with GN and ReLU, a stride-2 max-pool,
then four stages of bottleneck blocks (a 1-tap conv down to the stage's
width, a 7-tap conv, a 1-tap conv up to ``expansion`` times the width, each
with GN, ReLU after the first two; the residual join ``relu(conv3 +
shortcut)``, the shortcut a 1-tap projection with GN where the shape
changes).  Stages 2 and 3 halve the lattice in their first block's 7-tap
conv and projection; stage 4 keeps stage 3's lattice and dilates its 7-tap
convs by 2 instead (output stride 16).  ASPP: a 1-tap branch, 7-tap
branches at the ``aspp_rates`` dilations and an image-pooling branch (the
global mean, a 1-tap conv, broadcast back), each ``aspp_width`` channels
with GN and ReLU, concatenated and projected by a 1-tap conv with GN and
ReLU; a linear classifier gives per-cell logits at output stride 16, which
:func:`~hygrid_tpu_torch.ops.geometry.hexresize` (linear) brings back to
the input's lattice.

The hex mapping: a 3 x 3 conv is a radius-2 hex kernel (7 taps), 7 x 7
radius 4 (37 taps), 1 x 1 radius 1 (1 tap); the 3 x 3 stride-2 max-pool is
``hex_pool2d(kernel_size=3, stride=2, padding=1)``; bilinear upsampling is
the hex->hex linear resample.

Routes: every stride-1 conv runs as a :class:`HexConvStack` on kernel B's
NHWC route (conv, GN and ReLU in ``csrc/hex_conv_layer.cu``; a
bottleneck's third conv and a stride-1 projection without the ReLU); the
strided convs (the stem, the first blocks of stages 2 and 3) are
:class:`HexConv2dGN`, ``HexConv2d(stride=2)`` (cuDNN's per-parity
convolutions) with GN, under the span ``hygrid.conv_strided``.  The joins
are :func:`residual_join`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..nn import functional as F
from ..nn.layers import HexConv2d, HexConvStack
from ..ops.geometry import hexresize
from ..utils.profiling import count, span
from .hexcnn import _dense

__all__ = ["HexDeepLabV3", "HexBottleneck", "HexASPP", "HexConv2dGN",
           "residual_join"]

_GN_EPS = 1e-5


def _count(name: str, x: torch.Tensor):
    """The stage's counter, counted where it runs on the card (as the
    kernel wrappers count their launches), else None."""
    return count(name) if x.is_cuda else None


class _ResidualJoin(torch.autograd.Function):
    """``relu(a + b)`` in the inputs' dtype; its backward masks the output
    cotangent by the output and hands it to both inputs."""

    @staticmethod
    def forward(ctx, a, b):
        with span("hygrid.residual", _count("residual", a)):
            out = torch.relu(a + b)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        (out,) = ctx.saved_tensors
        with span("hygrid.residual_backward"):
            g = torch.where(out > 0, gout, torch.zeros((), dtype=gout.dtype,
                                                       device=gout.device))
        return g, g


def residual_join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A residual block's join ``relu(a + b)``, differentiable in both; each
    call on the card is counted as ``"residual"``, and each is traced as the
    span ``hygrid.residual`` (its backward as
    ``hygrid.residual_backward``)."""
    return _ResidualJoin.apply(a, b)


class HexConv2dGN(HexConv2d):
    """A hex conv with GroupNorm and an optional ReLU: :class:`HexConv2d`
    (cuDNN's per-parity convolutions on the card; the strided convs of
    :class:`HexDeepLabV3`), then per-sample GN over ``groups`` channel
    groups with float32 statistics (eps 1e-5) and scale ``gn_scale`` and
    shift ``gn_bias``, rounded to ``dtype``, then ReLU where ``relu``.

    ``data_format`` is the layout of input and output ("NCHW" or "NHWC");
    the conv runs on the NCHW view.  Each call on the card is counted as
    ``"conv_strided"``, and each is traced as the span
    ``hygrid.conv_strided``.
    """

    def __init__(self, in_channels: int, out_channels: int, radius: int,
                 stride: int, padding: int, *, groups: int = 32,
                 relu: bool = True, data_format: str = "NHWC",
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, 0, radius, stride=stride,
                         padding=padding, use_bias=False, dtype=dtype,
                         device=device, generator=generator)
        self.num_groups = math.gcd(groups, out_channels)
        self.relu, self.data_format = relu, data_format
        fkw = dict(device=device, dtype=torch.float32)
        self.gn_scale = nn.Parameter(torch.ones((out_channels,), **fkw))
        self.gn_bias = nn.Parameter(torch.zeros((out_channels,), **fkw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = self.data_format == "NHWC"
        with span("hygrid.conv_strided", _count("conv_strided", x)):
            dtype = self.dtype or x.dtype
            y = self._conv(x.permute(0, 3, 1, 2) if nhwc else x, self.kernel,
                           None)
            y = nn.functional.group_norm(y.float(), self.num_groups,
                                         self.gn_scale, self.gn_bias,
                                         _GN_EPS).to(dtype)
            if self.relu:
                y = torch.relu(y)
            return y.permute(0, 2, 3, 1).contiguous() if nhwc else y


class HexBottleneck(nn.Module):
    """ResNet's bottleneck block on NHWC activations: ``conv1`` (1 tap,
    ``in_channels -> width``), ``conv2`` (7 taps, dilated by ``dilation``
    at stride 1, or a :class:`HexConv2dGN` at stride 2), ``conv3`` (1 tap,
    ``width -> expansion * width``, GN without ReLU), each with GN; then
    :func:`residual_join` with the input, or with ``proj`` (1 tap, GN, no
    ReLU; strided with the block) where the shape changes."""

    def __init__(self, in_channels: int, width: int, *, expansion: int = 4,
                 stride: int = 1, dilation: int = 1, groups: int = 32,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = expansion * width
        kw = dict(norm="GN", num_groups=groups, data_format="NHWC",
                  dtype=dtype, device=device, generator=generator)
        skw = dict(groups=groups, dtype=dtype, device=device,
                   generator=generator)
        self.conv1 = HexConvStack(in_channels, width, 1, hexkernel_radius=1,
                                  **kw)
        if stride == 1:
            self.conv2 = HexConvStack(width, width, 1, hexkernel_radius=2,
                                      dilation=dilation, **kw)
        else:
            self.conv2 = HexConv2dGN(width, width, 2, stride, 1, **skw)
        self.conv3 = HexConvStack(width, out, 1, hexkernel_radius=1,
                                  final_activation=False, **kw)
        if stride != 1:
            self.proj = HexConv2dGN(in_channels, out, 1, stride, 0,
                                    relu=False, **skw)
        elif in_channels != out:
            self.proj = HexConvStack(in_channels, out, 1, hexkernel_radius=1,
                                     final_activation=False, **kw)
        else:
            self.proj = None

    @staticmethod
    def _run(layer, x, plain):
        return (layer(x, plain=plain) if isinstance(layer, HexConvStack)
                else layer(x))

    def forward(self, x: torch.Tensor, *, plain: bool = False
                ) -> torch.Tensor:
        h = self._run(self.conv1, x, plain)
        h = self._run(self.conv2, h, plain)
        h = self._run(self.conv3, h, plain)
        skip = x if self.proj is None else self._run(self.proj, x, plain)
        return residual_join(h, skip)


class HexASPP(nn.Module):
    """Atrous spatial pyramid pooling on NHWC activations: ``branch0`` (1
    tap), ``rates`` (7 taps dilated by each rate), ``pool`` (the global
    mean, a 1-tap conv, broadcast over the lattice), each ``width``
    channels with GN and ReLU, concatenated and projected by ``project``
    (1 tap, GN, ReLU)."""

    def __init__(self, in_channels: int, width: int = 256,
                 rates: Sequence[int] = (6, 12, 18), *, groups: int = 32,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(norm="GN", num_groups=groups, data_format="NHWC",
                  dtype=dtype, device=device, generator=generator)
        self.branch0 = HexConvStack(in_channels, width, 1,
                                    hexkernel_radius=1, **kw)
        self.rates = nn.ModuleList(
            HexConvStack(in_channels, width, 1, hexkernel_radius=2,
                         dilation=r, **kw) for r in rates)
        self.pool = HexConvStack(in_channels, width, 1, hexkernel_radius=1,
                                 **kw)
        self.project = HexConvStack((2 + len(rates)) * width, width, 1,
                                    hexkernel_radius=1, **kw)

    def forward(self, x: torch.Tensor, *, plain: bool = False
                ) -> torch.Tensor:
        b, h, w, _ = x.shape
        outs = [self.branch0(x, plain=plain)]
        outs += [branch(x, plain=plain) for branch in self.rates]
        pooled = F.hex_global_pool2d(x, "average", data_format="NHWC")
        pooled = self.pool(pooled[:, None, None, :].contiguous(), plain=plain)
        outs.append(pooled.expand(b, h, w, pooled.shape[-1]))
        return self.project(torch.cat(outs, dim=-1), plain=plain)


class HexDeepLabV3(nn.Module):
    """DeepLabv3 at output stride 16 on a bottleneck backbone with
    GroupNorm, on the hex lattice (see the module docstring).

    Args:
        num_classes: logits per cell.
        blocks: bottleneck blocks per stage (ResNet-50: 3, 4, 6, 3).
        widths: each stage's bottleneck width; its output is ``expansion``
            times that.  The stem has ``widths[0]`` channels.
        expansion: a bottleneck's output over its width.
        stem_radius: the stride-2 stem conv's hex radius (4: 37 taps).
        aspp_rates: the dilations of ASPP's 7-tap branches.
        aspp_width: channels of each ASPP branch and of its projection.
        groups: GroupNorm's groups (``gcd(groups, C)`` at C channels).
        in_channels: the input's channels.
        dtype: compute dtype; parameters stay float32.
        device / generator: where the parameters live (the card unless the
            caller asks for the CPU) and what initialises them.

    Takes hex images ``(B, in_channels, H, W)`` and returns per-cell logits
    ``(B, num_classes, H, W)``.  Stage ``s`` is ``layer{s + 1}``, a list of
    :class:`HexBottleneck`; then ``aspp`` and ``classifier``.
    """

    def __init__(self, num_classes: int,
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 expansion: int = 4, stem_radius: int = 4,
                 aspp_rates: Sequence[int] = (6, 12, 18),
                 aspp_width: int = 256, groups: int = 32,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(blocks) != 4 or len(widths) != 4:
            raise ValueError("HexDeepLabV3 has four stages: blocks and widths "
                             "need four entries each")
        self.dtype = dtype
        kw = dict(groups=groups, dtype=dtype, device=device,
                  generator=generator)
        self.stem = HexConv2dGN(in_channels, widths[0], stem_radius, 2,
                                stem_radius - 1, data_format="NCHW", **kw)
        cin = widths[0]
        # stages 2 and 3 halve the lattice; stage 4 dilates instead
        plan = [(1, 1), (2, 1), (2, 1), (1, 2)]
        for s, (n, width, (stride, dilation)) in enumerate(
                zip(blocks, widths, plan)):
            stage = nn.ModuleList()
            for i in range(n):
                stage.append(HexBottleneck(
                    cin, width, expansion=expansion,
                    stride=stride if i == 0 else 1, dilation=dilation, **kw))
                cin = expansion * width
            self.add_module(f"layer{s + 1}", stage)
        self.aspp = HexASPP(cin, aspp_width, aspp_rates, **kw)
        self.classifier = _dense(aspp_width, num_classes, device, generator)

    def forward(self, x: torch.Tensor, *, plain: bool = False
                ) -> torch.Tensor:
        """Per-cell logits ``(B, num_classes, H, W)`` of hex images ``(B,
        C, H, W)``; ``plain=True`` runs the conv stacks' plain versions.
        Each call is counted as ``"forward"`` and traced as the span
        ``hygrid.forward``, identified by that count."""
        with span("hygrid.forward", count("forward")):
            hw = tuple(x.shape[-2:])
            x = self.stem(x.to(self.dtype))
            x = F.hex_pool2d(x, "max", kernel_size=3, stride=2, padding=1)
            x = x.permute(0, 2, 3, 1).contiguous()
            for s in range(4):
                for block in getattr(self, f"layer{s + 1}"):
                    x = block(x, plain=plain)
            x = self.aspp(x, plain=plain)
            x = nn.functional.linear(x, self.classifier.weight.to(self.dtype),
                                     self.classifier.bias.to(self.dtype))
            return hexresize(x.permute(0, 3, 1, 2).contiguous(), hw, "linear")
