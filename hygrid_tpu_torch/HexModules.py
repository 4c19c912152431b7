"""Reference-named module alias: ``HyGrid.HexModules`` -> hygrid_tpu_torch."""
from .nn.modules import (CONV_LAYERS, register_conv_layer,
                         build_hexconv_layer, build_hexnorm_layer,
                         build_hexactivation_layer, build_hexpadding_layer,
                         HexConvModule)

__all__ = [
    "CONV_LAYERS", "register_conv_layer", "build_hexconv_layer",
    "build_hexnorm_layer", "build_hexactivation_layer",
    "build_hexpadding_layer", "HexConvModule",
]
