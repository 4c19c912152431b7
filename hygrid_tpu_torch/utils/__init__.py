"""Utilities of the PyTorch port."""
from .params import (hexcnn_state_dict_from_flax,
                     hexconvmodule_state_dict_from_flax,
                     hexconvnext_state_dict_from_flax,
                     hexresnet_state_dict_from_flax,
                     hexunet_state_dict_from_flax,
                     hexvit_state_dict_from_flax)

__all__ = ["hexcnn_state_dict_from_flax", "hexconvmodule_state_dict_from_flax",
           "hexconvnext_state_dict_from_flax", "hexresnet_state_dict_from_flax",
           "hexunet_state_dict_from_flax", "hexvit_state_dict_from_flax"]
