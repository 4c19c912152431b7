"""Resampling engine, geometry, padding, rotation, augmentation and
storage-conversion ops of the PyTorch port (``ops.tiled`` streams rasters
larger than the card)."""
from .convert import (heximage_to_type1, heximage_to_type2,
                      type1_to_heximage, type2_to_heximage)
from .geometry import (hex_to_rect_resample, hexresize,
                       image_geometric_transformation, rect_to_hex_resample,
                       warp_output_shape)
from .pad import heximpad, hex_impad_to_multiple
from .sampling import (SamplePlan, apply_plan, apply_plan_auto,
                       hex_sample_plan, rect_sample_plan)
from .hexrot import hexrot60, hexflip
from .augment import (hexrot60_same, random_hexrot60, random_hexflip,
                      random_hex_translate, augment_hex_batch)

__all__ = [
    "SamplePlan",
    "apply_plan",
    "apply_plan_auto",
    "hex_sample_plan",
    "rect_sample_plan",
    "hex_to_rect_resample",
    "hexresize",
    "image_geometric_transformation",
    "rect_to_hex_resample",
    "warp_output_shape",
    "heximpad",
    "hex_impad_to_multiple",
    "heximage_to_type1",
    "heximage_to_type2",
    "type1_to_heximage",
    "type2_to_heximage",
    "hexrot60",
    "hexflip",
    "hexrot60_same",
    "random_hexrot60",
    "random_hexflip",
    "random_hex_translate",
    "augment_hex_batch",
]
