"""Reference-named module alias: ``HyGrid.geometry_torch`` ->
hygrid_tpu_torch."""
from .compat import (image_geometric_transformation,
                     image_geometric_transformation_gpu,
                     image_geometric_transformation_cpu,
                     hex_to_square_resample)

__all__ = [
    "image_geometric_transformation",
    "image_geometric_transformation_gpu",
    "image_geometric_transformation_cpu",
    "hex_to_square_resample",
]
