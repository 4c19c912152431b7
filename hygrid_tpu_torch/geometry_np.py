"""Reference-named module alias: ``HyGrid.geometry_np`` -> hygrid_tpu_torch.

The reference keeps three near-identical geometry backends; here every
alias resolves to the port's one set of ops (tensors on the card unless
the input or ``device=`` says otherwise)."""
from .compat import (image_geometric_transformation, hex_to_rect_resample,
                     rect_to_hex_resample, hexresize)
from .ops.pad import heximpad, hex_impad_to_multiple

__all__ = [
    "image_geometric_transformation", "hex_to_rect_resample",
    "rect_to_hex_resample", "hexresize", "heximpad",
    "hex_impad_to_multiple",
]
