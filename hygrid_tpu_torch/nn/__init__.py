"""Hex NN layer of the PyTorch port: functional ops and modules."""
from . import filters, functional
from .functional import (hex_conv2d, hex_conv2d_output_shape,
                         hex_global_pool2d, hex_kernel_num, hex_pool2d)
from .layers import HexConvStack

__all__ = [
    "filters",
    "functional",
    "hex_conv2d",
    "hex_conv2d_output_shape",
    "hex_global_pool2d",
    "hex_kernel_num",
    "hex_pool2d",
    "HexConvStack",
]
