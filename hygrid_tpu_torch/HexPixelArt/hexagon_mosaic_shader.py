"""Alias of ``HyGrid.HexPixelArt.hexagon_mosaic_shader``.

The GLSL program became the mosaic resample
(``hygrid_tpu_torch.viz.render``); ``Hexagon_Mosaic_shader`` is kept as a
thin stand-in whose "uniforms" feed :func:`render_mosaic`.
"""
import math

from ..viz.render import ViewState, render_mosaic

__all__ = ["Hexagon_Mosaic_shader", "ViewState", "render_mosaic"]


class Hexagon_Mosaic_shader:
    """API-shaped stand-in for the GLSL shader object
    (``hexagon_mosaic_shader.py:10-120``): uniforms accumulate into plain
    state and ``render`` runs the mosaic resample."""

    def __init__(self):
        self.uniforms = {}

    def use(self):
        return self

    def setUniform(self, name, value):
        self.uniforms[name] = value

    def setAttrib(self, *args, **kwargs):
        pass  # vertex layout is meaningless without a GL pipeline

    def render(self, hex_image, out_size, device="cuda"):
        """The mosaic of ``hex_image`` at ``out_size``; a numpy image goes
        to ``device`` first."""
        view = ViewState(hierarchy=-int(math.log2(
            self.uniforms.get("hexmosaicSizeRatio", 1.0))))
        return render_mosaic(hex_image, out_size,
                             int(self.uniforms.get("even_odd_offset", 0)),
                             view, device=device)
