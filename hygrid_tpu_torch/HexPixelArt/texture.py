"""Alias of ``HyGrid.HexPixelArt.texture`` (offscreen rebuild)."""
from ..viz.pixelart import Texture

__all__ = ["Texture"]
