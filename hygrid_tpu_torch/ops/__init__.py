"""Resampling engine and geometry ops of the PyTorch port."""
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
]
