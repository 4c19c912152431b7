"""``torch.nn.Module`` hex layers (layer L3), PyTorch port of
``hygrid_tpu/nn/layers.py``: the per-op conv layers, the conv stack and the
pooling classes.  Each conv layer's parameters default to the card
(``device="cuda"``) and take a ``generator`` for their init."""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from . import functional as F

__all__ = ["HexConv2d", "HexConv2dAdaptivePadding", "HexConvStack",
           "HexPool2d", "HexAdaptivePool2d", "HexGlobalPool2d"]


def _kaiming_hex_init(tensor: torch.Tensor, fan_in: int,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch ``kaiming_uniform_(a=sqrt(5))`` on the flat hex kernel:
    uniform in ``+-1/sqrt(fan_in)`` (``hygrid_tpu/nn/layers.py:29-35``)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


class HexConv2d(nn.Module):
    """Hexagonal convolution (``hygrid_tpu/nn/layers.py:38-101``,
    ``HexFrames.py:22-185``).

    The parameter is the flat hex kernel ``kernel`` ``(out_channels,
    in_channels // groups, kernelnum)``, and ``bias`` ``(out_channels,)``
    with ``use_bias`` (the reference's ``bias``), both initialised uniform
    in ``+-1/sqrt(fan_in)``.  ``impl`` is :func:`F.hex_conv2d`'s (default
    ``"auto"``); ``dtype`` casts the parameters for the conv (None keeps
    ``param_dtype``, so the conv computes in it whatever the input's
    dtype: ``hex_conv2d`` casts the input to the kernel's dtype).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 even_odd_offset: int, hexkernel_radius: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, use_bias: bool = True,
                 padding_mode: str = "constant", padding_value: float = 0.0,
                 impl: str = "auto", param_dtype: torch.dtype = torch.float32,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups:
            raise ValueError("in_channels must be divisible by groups")
        if out_channels % groups:
            raise ValueError("out_channels must be divisible by groups")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.even_odd_offset = even_odd_offset
        self.hexkernel_radius = hexkernel_radius
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.padding_mode, self.padding_value = padding_mode, padding_value
        self.impl, self.dtype = impl, dtype
        fan_in = (in_channels // groups) * self.kernelnum
        fkw = dict(device=device, dtype=param_dtype)
        self.kernel = nn.Parameter(_kaiming_hex_init(
            torch.empty((out_channels, in_channels // groups, self.kernelnum),
                        **fkw), fan_in, generator))
        self.bias = (nn.Parameter(_kaiming_hex_init(
            torch.empty((out_channels,), **fkw), fan_in, generator))
            if use_bias else None)

    @property
    def kernelnum(self) -> int:
        return F.hex_kernel_num(self.hexkernel_radius)

    @property
    def out_even_odd_offset(self) -> int:
        return 0  # HexFrames.py:56

    def forward(self, x):
        return self._conv(x, self.kernel, self.bias)

    def _conv(self, x, kernel, bias):
        """The conv with the given (possibly spectrally normalised)
        parameters."""
        if self.dtype is not None:
            kernel = kernel.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        return F.hex_conv2d(
            x, kernel, bias, even_odd_offset=self.even_odd_offset,
            radius=self.hexkernel_radius, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            padding_mode=self.padding_mode, padding_value=self.padding_value,
            impl=self.impl)


class HexConv2dAdaptivePadding(HexConv2d):
    """TF-"same" adaptive padding variant (``hygrid_tpu/nn/layers.py:104-
    119``, ``HexFrames.py:187-253``).

    The reference's quirks are kept: ``padding`` is accepted and discarded,
    the width rule makes stride-1 outputs one column wider than the input,
    and ``dtype`` is not applied (the parameters enter in
    ``param_dtype``).
    """

    def _conv(self, x, kernel, bias):
        return F.hex_conv2d_adaptive_padding(
            x, kernel, bias, even_odd_offset=self.even_odd_offset,
            radius=self.hexkernel_radius, stride=self.stride,
            dilation=self.dilation, groups=self.groups, impl=self.impl)


class HexConvStack(nn.Module):
    """A uniform-width chain of 'same' hex conv (+ GroupNorm) (+ ReLU)
    layers, run by :func:`hygrid_tpu_torch.kernels.conv_stack.hex_conv_stack`
    (the hex conv layer kernel on CUDA, its plain version on the CPU).  For
    an input offset other than 0 it runs the reference's per-op chain
    (``hygrid_tpu/nn/layers.py:306-323``): ``hex_conv2d(impl="auto")`` with
    padding ``radius - 1``, GroupNorm, ReLU, layer by layer on NCHW.
    ``forward(x, extra=skip)`` is the skip-join stage of a UNet decoder.

    Layer 0 maps ``in_channels -> width``; later layers ``width -> width``.
    Parameters carry ``hygrid_tpu``'s names: ``kernel_{i}`` ``(width, cin,
    kn)``, ``bias_{i}`` (only with a bias), ``gn_scale_{i}`` and
    ``gn_bias_{i}`` (with ``norm="GN"``).

    Args:
        in_channels / width / depth: channel plan and number of layers.
        hexkernel_radius: hex kernel radius (padding ``dilation*(r-1)``).
        norm: ``"GN"`` (``gcd(num_groups, width)`` groups) or None.
        use_bias: True, False or ``"auto"`` (a bias only without a norm).
        final_activation: apply the last layer's ReLU.
        data_format: layout of input and output, "NCHW" or "NHWC".
        dtype: compute dtype (parameters stay ``param_dtype``); None keeps
            the input's dtype.
        device / generator: where the parameters live (the card unless
            the caller asks for the CPU), and the generator that initialises
            them.
    """

    def __init__(self, in_channels: int, width: int, depth: int, *,
                 even_odd_offset: int = 0, hexkernel_radius: int = 2,
                 dilation: int = 1, norm: Optional[str] = "GN",
                 num_groups: int = 8, activation: Optional[str] = "relu",
                 final_activation: bool = True,
                 use_bias: Union[bool, str] = "auto",
                 data_format: str = "NCHW",
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in (None, "GN"):
            raise ValueError(
                f"HexConvStack supports norm None or 'GN', got {norm!r}")
        if activation not in (None, "none", "relu"):
            raise ValueError("HexConvStack fuses only ReLU (or None)")
        self.even_odd_offset = even_odd_offset
        self.in_channels, self.width, self.depth = in_channels, width, depth
        self.hexkernel_radius, self.dilation = hexkernel_radius, dilation
        self.norm, self.num_groups = norm, num_groups
        self.activation, self.final_activation = activation, final_activation
        self.data_format, self.dtype = data_format, dtype
        self.with_bias = bool(norm is None if use_bias == "auto" else use_bias)
        kn = F.hex_kernel_num(hexkernel_radius)
        fkw = dict(device=device, dtype=param_dtype)
        for li in range(depth):
            cin = in_channels if li == 0 else width
            fan_in = cin * kn
            self.register_parameter(f"kernel_{li}", nn.Parameter(
                _kaiming_hex_init(torch.empty((width, cin, kn), **fkw),
                                  fan_in, generator)))
            if self.with_bias:
                self.register_parameter(f"bias_{li}", nn.Parameter(
                    _kaiming_hex_init(torch.empty((width,), **fkw), fan_in,
                                      generator)))
            if norm == "GN":
                self.register_parameter(f"gn_scale_{li}", nn.Parameter(
                    torch.ones((width,), **fkw)))
                self.register_parameter(f"gn_bias_{li}", nn.Parameter(
                    torch.zeros((width,), **fkw)))

    @property
    def gn_groups(self) -> int:
        return math.gcd(self.num_groups, self.width)

    def forward(self, x: torch.Tensor, *, extra: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        """Run the stack; ``plain=True`` uses the layers' plain versions on
        any device.

        ``extra`` makes this a skip-join stage (``hygrid_tpu``'s
        ``_call_split``, ``nn/layers.py:325-370``): the chain runs on the
        channel concatenation ``concat([x, extra])``, and ``in_channels``
        counts both inputs.  Layer 0 is then the split layer
        (:func:`~hygrid_tpu_torch.kernels.conv_stack.hex_conv_layer_split`),
        which never builds the concatenation; the stage is differentiable
        in both inputs.
        """
        from ..kernels.conv_stack import hex_conv_stack
        nhwc = self.data_format == "NHWC"
        dtype = self.dtype or x.dtype
        if extra is not None:
            cax = -1 if nhwc else 1
            ca, cb = x.shape[cax], extra.shape[cax]
            if ca + cb != self.in_channels:
                raise ValueError(
                    f"split inputs carry {ca}+{cb} channels; the stage was "
                    f"built for in_channels={self.in_channels}")
            extra = extra.to(dtype)
        x = x.to(dtype)
        p = dict(self.named_parameters())
        kernels = [p[f"kernel_{i}"].to(dtype) for i in range(self.depth)]
        biases = ([p[f"bias_{i}"].to(dtype) for i in range(self.depth)]
                  if self.with_bias else None)
        norms = None
        if self.norm == "GN":
            norms = [("gn", self.gn_groups, p[f"gn_scale_{i}"],
                      p[f"gn_bias_{i}"]) for i in range(self.depth)]
        if self.even_odd_offset != 0:
            if extra is not None:
                x = torch.cat([x, extra], dim=-1 if nhwc else 1)
            h = self._per_op_chain(x.permute(0, 3, 1, 2) if nhwc else x,
                                   kernels, biases, norms)
            return h.permute(0, 2, 3, 1) if nhwc else h
        return hex_conv_stack(
            x, kernels, biases, radius=self.hexkernel_radius,
            dilation=self.dilation,
            activation="relu" if self.activation == "relu" else None,
            final_activation=self.final_activation, norms=norms,
            data_format=self.data_format, extra_input=extra, plain=plain)

    def _per_op_chain(self, h, kernels, biases, norms):
        """The reference's per-op chain on NCHW ``h`` (offset != 0)."""
        from ..kernels.conv_stack import _group_norm_nchw
        relu = self.activation == "relu"
        for li in range(self.depth):
            h = F.hex_conv2d(
                h, kernels[li], None if biases is None else biases[li],
                even_odd_offset=self.even_odd_offset if li == 0 else 0,
                radius=self.hexkernel_radius,
                padding=self.hexkernel_radius - 1, dilation=self.dilation,
                impl="auto")
            if norms is not None:
                _, groups, gamma, beta = norms[li]
                h = _group_norm_nchw(h, groups, gamma.float(), beta.float())
            if relu and (self.final_activation or li < self.depth - 1):
                h = torch.relu(h)
        return h


class HexPool2d(nn.Module):
    """Strided hex pooling (``hygrid_tpu/nn/layers.py:373-407``,
    ``HexFrames.py:255-341``); parameter-free.  ``stride=None`` defaults to
    ``kernel_size``, as documented (the reference crashes on it)."""

    def __init__(self, method: str, kernel_size=2, stride=None, padding=0,
                 even_odd_offset=0, padding_mode="constant", padding_value=0,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divisor_override: Optional[int] = None):
        super().__init__()
        F._reduction(method)  # validate eagerly, like the reference ctor
        self.method, self.kernel_size, self.stride = method, kernel_size, stride
        self.padding, self.even_odd_offset = padding, even_odd_offset
        self.padding_mode, self.padding_value = padding_mode, padding_value
        self.ceil_mode, self.count_include_pad = ceil_mode, count_include_pad
        self.out_offset = 0

    def forward(self, x):
        return F.hex_pool2d(
            x, self.method, kernel_size=self.kernel_size, stride=self.stride,
            padding=self.padding, even_odd_offset=self.even_odd_offset,
            padding_mode=self.padding_mode, padding_value=self.padding_value,
            ceil_mode=self.ceil_mode, count_include_pad=self.count_include_pad)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class HexAdaptivePool2d(nn.Module):
    """Adaptive output-size pooling (``hygrid_tpu/nn/layers.py:410-426``):
    constructible, and ``(h, w)`` outsizes accepted, as documented."""

    def __init__(self, outsize, method: str, padding=0,
                 padding_mode="constant", padding_value=0):
        super().__init__()
        F._reduction(method)
        self.outsize, self.method = outsize, method

    def forward(self, x):
        return F.hex_adaptive_pool2d(x, self.outsize, self.method)


class HexGlobalPool2d(nn.Module):
    """Global pooling over the flattened spatial dims
    (``hygrid_tpu/nn/layers.py:429-438``)."""

    def __init__(self, method: str):
        super().__init__()
        F._reduction(method)
        self.method = method

    def forward(self, x):
        return F.hex_global_pool2d(x, self.method)
