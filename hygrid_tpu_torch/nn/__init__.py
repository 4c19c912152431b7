"""Hex NN layer of the PyTorch port: functional ops and modules."""
from . import experimental, filters, functional, modules
from .functional import (average_pooling, hex_adaptive_pool2d, hex_conv2d,
                         hex_conv2d_adaptive_padding, hex_conv2d_output_shape,
                         hex_global_pool2d, hex_kernel_num, hex_pool2d,
                         max_pooling, min_pooling, pad2d, scatter_hex_kernel)
from .layers import (HexAdaptivePool2d, HexConv2d, HexConv2dAdaptivePadding,
                     HexConvStack, HexGlobalPool2d, HexPool2d)
from .modules import (CONV_LAYERS, HexConvModule, build_hexactivation_layer,
                      build_hexconv_layer, build_hexnorm_layer,
                      build_hexpadding_layer, register_conv_layer)

__all__ = [
    "experimental",
    "filters",
    "functional",
    "modules",
    "pad2d",
    "scatter_hex_kernel",
    "max_pooling",
    "min_pooling",
    "average_pooling",
    "hex_adaptive_pool2d",
    "hex_conv2d",
    "hex_conv2d_adaptive_padding",
    "hex_conv2d_output_shape",
    "hex_global_pool2d",
    "hex_kernel_num",
    "hex_pool2d",
    "HexAdaptivePool2d",
    "HexConv2d",
    "HexConv2dAdaptivePadding",
    "HexConvStack",
    "HexGlobalPool2d",
    "HexPool2d",
    "CONV_LAYERS",
    "HexConvModule",
    "build_hexactivation_layer",
    "build_hexconv_layer",
    "build_hexnorm_layer",
    "build_hexpadding_layer",
    "register_conv_layer",
]
