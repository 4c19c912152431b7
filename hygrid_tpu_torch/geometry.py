"""Reference-named module alias: ``HyGrid.geometry`` (numba backend) ->
hygrid_tpu_torch.  One resample call covers all channels (the
``plan_gather`` kernel on the card)."""
from .compat import (image_geometric_transformation,
                     image_geometric_transformation_gpu,
                     image_geometric_transformation_cpu,
                     hex_to_square_resample, hexresize)

__all__ = [
    "image_geometric_transformation",
    "image_geometric_transformation_gpu",
    "image_geometric_transformation_cpu",
    "hex_to_square_resample", "hexresize",
]
