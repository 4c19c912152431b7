"""Reference-named module alias: ``HyGrid.Image`` -> hygrid_tpu_torch."""
from .image.image import IMAGE

__all__ = ["IMAGE"]
