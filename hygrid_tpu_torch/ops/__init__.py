"""Resampling engine, geometry ops and storage conversions of the PyTorch
port."""
from .convert import (heximage_to_type1, heximage_to_type2,
                      type1_to_heximage, type2_to_heximage)
from .geometry import (hex_to_rect_resample, hexresize,
                       image_geometric_transformation, rect_to_hex_resample,
                       warp_output_shape)
from .sampling import (SamplePlan, apply_plan, apply_plan_auto,
                       hex_sample_plan, rect_sample_plan)

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
    "heximage_to_type1",
    "heximage_to_type2",
    "type1_to_heximage",
    "type2_to_heximage",
]
