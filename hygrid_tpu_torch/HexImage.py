"""Reference-named module alias: ``HyGrid.HexImage`` -> hygrid_tpu_torch."""
from .image.image import HEXIMAGE

__all__ = ["HEXIMAGE"]
