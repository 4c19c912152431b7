"""Reference-named module alias: ``HyGrid.HexFrames`` -> hygrid_tpu_torch.

Lets reference code port by changing only the import root::

    from hygrid_tpu_torch import HexFrames  # was: from HyGrid import HexFrames

Function names and semantics match ``hygrid_tpu.HexFrames``; the classes
are ``torch.nn.Module`` s.
"""
from .nn.functional import (pad2d as pad, hex_kernel_num, hex_conv2d,
                            hex_pool2d, max_pooling, min_pooling,
                            average_pooling)
from .nn.layers import (HexConv2d, HexConv2dAdaptivePadding, HexPool2d,
                        HexAdaptivePool2d, HexGlobalPool2d)
from .ops.convert import (heximage_to_type1, heximage_to_type2,
                          type1_to_heximage)

__all__ = [
    "pad", "hex_kernel_num", "hex_conv2d", "hex_pool2d",
    "max_pooling", "min_pooling", "average_pooling",
    "HexConv2d", "HexConv2dAdaptivePadding", "HexPool2d",
    "HexAdaptivePool2d", "HexGlobalPool2d",
    "heximage_to_type1", "heximage_to_type2", "type1_to_heximage",
]
