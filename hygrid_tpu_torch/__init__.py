"""hygrid_tpu_torch: the PyTorch/CUDA port of hygrid_tpu for NVIDIA Hopper.

Mirrors ``hygrid_tpu``'s module paths and public names.  Plain tensor code
is PyTorch; the TPU kernels on the ported path are CUDA C++ kernels for
``sm_90a`` (``csrc/``), built with ``nvcc`` at their first launch.  Importing
the package needs neither JAX nor a GPU nor ``nvcc``, and creates no
process group.
"""
from . import lattice
from . import compat  # noqa: F401  (reference API shims)
from . import nn  # noqa: F401
from . import models  # noqa: F401
from . import parallel  # noqa: F401
from . import viz  # noqa: F401
from . import utils  # noqa: F401
# registers the hygrid ops, which loading an exported program needs
from .kernels import (conv_single, conv_stack, pool,  # noqa: F401
                      resample, resample_shift)
from .image import IMAGE, HEXIMAGE
from .lattice import HexSpec
from .ops.geometry import (hex_to_rect_resample, hexresize,
                           image_geometric_transformation,
                           rect_to_hex_resample, warp_output_shape)
from .ops.convert import (heximage_to_type1, heximage_to_type2,
                          type1_to_heximage, type2_to_heximage)
from .ops.pad import heximpad, hex_impad_to_multiple
from .ops.hexrot import hexrot60, hexflip
from .ops.augment import (hexrot60_same, random_hexrot60, random_hexflip,
                          random_hex_translate, augment_hex_batch)
from .ops.sampling import SamplePlan, apply_plan, apply_plan_auto
from .nn.functional import (hex_conv2d, hex_conv2d_output_shape,
                            hex_global_pool2d, hex_kernel_num, hex_pool2d)
from .nn.layers import HexConv2d, HexConvStack
from .nn.modules import HexConvModule
from .models import (HexCNN, HexUNet, create_train_state, hexcnn_small,
                     hexcnn_tiny, hexify_batch, train_step)

__version__ = "0.1.0"

__all__ = [
    "lattice",
    "compat",
    "nn",
    "models",
    "parallel",
    "viz",
    "utils",
    "IMAGE",
    "HEXIMAGE",
    "HexSpec",
    "hex_to_rect_resample",
    "hexresize",
    "image_geometric_transformation",
    "rect_to_hex_resample",
    "warp_output_shape",
    "heximpad",
    "hex_impad_to_multiple",
    "heximage_to_type1",
    "heximage_to_type2",
    "type1_to_heximage",
    "type2_to_heximage",
    "hexrot60",
    "hexflip",
    "hexrot60_same",
    "random_hexrot60",
    "random_hexflip",
    "random_hex_translate",
    "augment_hex_batch",
    "SamplePlan",
    "apply_plan",
    "apply_plan_auto",
    "hex_conv2d",
    "hex_conv2d_output_shape",
    "hex_global_pool2d",
    "hex_kernel_num",
    "hex_pool2d",
    "HexConv2d",
    "HexConvModule",
    "HexConvStack",
    "HexCNN",
    "HexUNet",
    "hexcnn_small",
    "hexcnn_tiny",
    "hexify_batch",
    "create_train_state",
    "train_step",
]
