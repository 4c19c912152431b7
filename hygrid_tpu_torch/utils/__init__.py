"""Utilities of the PyTorch port: the native tile loader, profiling,
checkpoints and the flax weight converters.  ``hygrid_tpu.utils``'s
``export_*`` names (``utils/export.py`` on ``torch.export``) are not
ported yet: they need the kernel wrappers registered as ``torch.library``
custom ops first."""
from .native_loader import (NativeTileLoader, RawRasterSpec,
                            native_available, read_raw_raster,
                            write_raw_raster)
from .profiling import annotate, benchmark, device_timer, get_logger
from .checkpoint import HAS_ORBAX, restore_checkpoint, save_checkpoint
from .params import (flax_tree_from_npz, hexcnn_state_dict_from_flax,
                     hexconvmodule_state_dict_from_flax,
                     hexconvnext_state_dict_from_flax,
                     hexresnet_state_dict_from_flax,
                     hexunet_state_dict_from_flax,
                     hexvit_state_dict_from_flax)

__all__ = ["NativeTileLoader", "RawRasterSpec", "native_available",
           "read_raw_raster", "write_raw_raster",
           "annotate", "device_timer", "benchmark", "get_logger",
           "save_checkpoint", "restore_checkpoint", "HAS_ORBAX",
           "flax_tree_from_npz",
           "hexcnn_state_dict_from_flax", "hexconvmodule_state_dict_from_flax",
           "hexconvnext_state_dict_from_flax", "hexresnet_state_dict_from_flax",
           "hexunet_state_dict_from_flax", "hexvit_state_dict_from_flax"]
