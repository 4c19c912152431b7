"""Reference-named package alias: ``HyGrid.HexPixelArt`` ->
hygrid_tpu_torch.viz."""
from ..viz.pixelart import Window, Texture

__all__ = ["Window", "Texture"]
