"""Utilities of the PyTorch port: the native tile loader, profiling,
checkpoints, ahead-of-time export on ``torch.export`` (``export.py``: the
kernels stay in the exported program as ``hygrid`` ops) and the flax
weight converters."""
from .native_loader import (NativeTileLoader, RawRasterSpec,
                            native_available, read_raw_raster,
                            write_raw_raster)
from .profiling import (annotate, benchmark, count, counts, device_timer,
                        get_logger, span)
from .checkpoint import HAS_ORBAX, restore_checkpoint, save_checkpoint
from .export import (export_fn, export_inference, exported_info,
                     load_exported)
from .params import (flax_tree_from_npz, hexcnn_state_dict_from_flax,
                     hexconvmodule_state_dict_from_flax,
                     hexconvnext_state_dict_from_flax,
                     hexresnet_state_dict_from_flax,
                     hexunet_state_dict_from_flax,
                     hexvit_state_dict_from_flax)

__all__ = ["export_fn", "export_inference", "load_exported",
           "exported_info", "NativeTileLoader", "RawRasterSpec", "native_available",
           "read_raw_raster", "write_raw_raster",
           "span", "annotate", "count", "counts", "device_timer", "benchmark",
           "get_logger",
           "save_checkpoint", "restore_checkpoint", "HAS_ORBAX",
           "flax_tree_from_npz",
           "hexcnn_state_dict_from_flax", "hexconvmodule_state_dict_from_flax",
           "hexconvnext_state_dict_from_flax", "hexresnet_state_dict_from_flax",
           "hexunet_state_dict_from_flax", "hexvit_state_dict_from_flax"]
