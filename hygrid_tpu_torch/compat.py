"""Reference API compatibility shims, PyTorch port of
``hygrid_tpu/compat.py``.

One-to-one name mapping so code written against the reference's modules
ports by changing only imports:

=====================================  =====================================
reference                              hygrid_tpu_torch
=====================================  =====================================
``geometry_np.image_geometric_transformation``  ``compat.image_geometric_transformation``
``geometry_np.hex_to_rect_resample``   ``compat.hex_to_rect_resample``
``geometry_np.rect_to_hex_resample``   ``compat.rect_to_hex_resample``
``geometry_np.hexresize``              ``compat.hexresize``
``geometry_np.heximpad``               ``compat.heximpad``
``geometry_np.hex_impad_to_multiple``  ``compat.hex_impad_to_multiple``
``geometry_torch.hex_to_square_resample``  ``compat.hex_to_square_resample``
``geometry_torch.image_geometric_transformation_gpu`` / ``geometry.*_gpu``
                                       ``compat.image_geometric_transformation_gpu``
``geometry.image_geometric_transformation_cpu``  ``compat.image_geometric_transformation_cpu``
``HexFrames.*`` (classes/fns)          ``hygrid_tpu_torch.nn`` (same names)
``HexModules.*``                       ``hygrid_tpu_torch.nn.modules``
``Image.IMAGE`` / ``HexImage.HEXIMAGE``  ``hygrid_tpu_torch.image``
``HexPixelArt.window/texture``         ``hygrid_tpu_torch.viz.pixelart``
=====================================  =====================================

The un-suffixed names are the port's ops: they return tensors, on the
card unless the input is a tensor elsewhere or ``device=`` says otherwise.
The device-suffixed names return numpy, as the reference's ``.cpu().numpy()``
tails do: ``_gpu`` and ``hex_to_square_resample`` run on ``device`` (the
card by default), ``_cpu`` on the CPU.  A bfloat16 result comes back as
float32 (the cast is exact): numpy has no bfloat16, where the reference
returns an ``ml_dtypes`` bfloat16 array.
"""
from __future__ import annotations

import torch

from .ops.geometry import (
    image_geometric_transformation,
    hex_to_rect_resample,
    rect_to_hex_resample,
    hexresize,
)
from .ops.pad import heximpad, hex_impad_to_multiple
from .ops.convert import (
    heximage_to_type1, heximage_to_type2, type1_to_heximage)
from .image import IMAGE, HEXIMAGE
from .image.image import _numpy

__all__ = [
    "image_geometric_transformation",
    "image_geometric_transformation_gpu",
    "image_geometric_transformation_cpu",
    "hex_to_rect_resample",
    "hex_to_square_resample",
    "rect_to_hex_resample",
    "hexresize",
    "heximpad",
    "hex_impad_to_multiple",
    "heximage_to_type1",
    "heximage_to_type2",
    "type1_to_heximage",
    "IMAGE",
    "HEXIMAGE",
]



def hex_to_square_resample(hex_image, rect_dsize=None,
                           interpolation="nearest", offset=0, device=None):
    """torch-backend name for hex->rect (``geometry_torch.py:296-446``);
    returns numpy like the reference's ``.cpu().numpy()`` tail."""
    return _numpy(hex_to_rect_resample(hex_image, rect_dsize, interpolation,
                                       offset, device=device or "cuda"))


def image_geometric_transformation_gpu(image, H=None, interpolation="nearest",
                                       offset=0, device=None):
    """GPU-suffixed warp (``geometry_torch.py:7-295``, ``geometry.py:156``),
    on ``device`` (the card by default); returns numpy."""
    return _numpy(image_geometric_transformation(
        image, H, interpolation, offset, device=device or "cuda"))


def image_geometric_transformation_cpu(image, H=None, interpolation="nearest",
                                       offset=0):
    """CPU name of the warp (``geometry.py:354-435``), run on the CPU;
    returns numpy."""
    if torch.is_tensor(image):
        image = image.detach().cpu()
    return _numpy(image_geometric_transformation(image, H, interpolation,
                                                 offset, device="cpu"))
