"""Visualisation layer (L5) of the PyTorch port: the hexagon-mosaic
renderer and the offscreen viewer shell (``Texture``, ``Window``)."""
from .render import ViewState, mosaic_plan, render_mosaic
from .pixelart import Texture, Window

__all__ = ["ViewState", "mosaic_plan", "render_mosaic", "Texture", "Window"]
