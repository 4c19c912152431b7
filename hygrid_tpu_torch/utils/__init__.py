"""Utilities of the PyTorch port: the flax weight converters and the
native tile loader."""
from .native_loader import (NativeTileLoader, RawRasterSpec,
                            native_available, read_raw_raster,
                            write_raw_raster)
from .params import (hexcnn_state_dict_from_flax,
                     hexconvmodule_state_dict_from_flax,
                     hexconvnext_state_dict_from_flax,
                     hexresnet_state_dict_from_flax,
                     hexunet_state_dict_from_flax,
                     hexvit_state_dict_from_flax)

__all__ = ["NativeTileLoader", "RawRasterSpec", "native_available",
           "read_raw_raster", "write_raw_raster",
           "hexcnn_state_dict_from_flax", "hexconvmodule_state_dict_from_flax",
           "hexconvnext_state_dict_from_flax", "hexresnet_state_dict_from_flax",
           "hexunet_state_dict_from_flax", "hexvit_state_dict_from_flax"]
