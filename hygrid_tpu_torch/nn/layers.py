"""``torch.nn.Module`` hex layers (layer L3), PyTorch port of the parts of
``hygrid_tpu/nn/layers.py`` that the HexCNN inference path needs."""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from . import functional as F

__all__ = ["HexConvStack"]


def _kaiming_hex_init(tensor: torch.Tensor, fan_in: int,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch ``kaiming_uniform_(a=sqrt(5))`` on the flat hex kernel:
    uniform in ``+-1/sqrt(fan_in)`` (``hygrid_tpu/nn/layers.py:29-35``)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


class HexConvStack(nn.Module):
    """A uniform-width chain of 'same' hex conv (+ GroupNorm) (+ ReLU)
    layers, run by :func:`hygrid_tpu_torch.kernels.conv_stack.hex_conv_stack`
    (the hex conv layer kernel on CUDA, its plain version on the CPU).

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
        if even_odd_offset != 0:
            raise NotImplementedError(
                "HexConvStack runs offset-0 input only (the per-op chain for "
                "other offsets is not ported yet)")
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

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """Run the stack; ``plain=True`` uses the layers' plain versions on
        any device."""
        from ..kernels.conv_stack import hex_conv_stack
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        p = dict(self.named_parameters())
        kernels = [p[f"kernel_{i}"].to(dtype) for i in range(self.depth)]
        biases = ([p[f"bias_{i}"].to(dtype) for i in range(self.depth)]
                  if self.with_bias else None)
        norms = None
        if self.norm == "GN":
            norms = [("gn", self.gn_groups, p[f"gn_scale_{i}"],
                      p[f"gn_bias_{i}"]) for i in range(self.depth)]
        return hex_conv_stack(
            x, kernels, biases, radius=self.hexkernel_radius,
            dilation=self.dilation,
            activation="relu" if self.activation == "relu" else None,
            final_activation=self.final_activation, norms=norms,
            data_format=self.data_format, plain=plain)
