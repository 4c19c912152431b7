"""Raster I/O layer (L4) of the PyTorch port: IMAGE/HEXIMAGE classes and
codecs."""
from .image import IMAGE, HEXIMAGE
from .codecs import (
    read_raster, write_raster, read_heximg, write_heximg, CRS,
    HAS_PIL, HAS_CV2)

__all__ = [
    "IMAGE", "HEXIMAGE",
    "read_raster", "write_raster", "read_heximg", "write_heximg", "CRS",
    "HAS_PIL", "HAS_CV2",
]
