"""Alias of ``HyGrid.HexPixelArt.window`` (offscreen rebuild)."""
from ..viz.pixelart import Window

__all__ = ["Window"]
