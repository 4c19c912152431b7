"""Visualisation layer (L5) of the PyTorch port: the hexagon-mosaic
renderer.  ``hygrid_tpu``'s offscreen viewer shell (``Texture``,
``Window``) waits for the port's ``image/`` package."""
from .render import ViewState, mosaic_plan, render_mosaic

__all__ = ["ViewState", "mosaic_plan", "render_mosaic"]
