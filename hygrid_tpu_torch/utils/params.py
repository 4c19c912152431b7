"""Weight conversion from ``hygrid_tpu``'s flax parameters to the port's
``state_dict``s.  Takes plain nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``) and imports no JAX."""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

__all__ = ["hexcnn_state_dict_from_flax"]


def hexcnn_state_dict_from_flax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexCNN` from the
    flax ``params`` of ``hygrid_tpu.models.HexCNN`` (stacked GN/None route).

    Accepts the ``params`` tree itself or ``{"params": tree}``.  Stage
    leaves keep their names (``stage{s}/kernel_{i}`` -> ``stage{s}.kernel_{i}``,
    likewise ``bias_{i}``, ``gn_scale_{i}``, ``gn_bias_{i}``); the Dense
    ``head/kernel`` ``(in, out)`` becomes ``head.weight`` ``(out, in)``.
    """
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in sorted(k for k in tree if k.startswith("stage")):
        for leaf, value in sorted(tree[name].items()):
            if isinstance(value, Mapping):
                raise ValueError(
                    f"{name}/{leaf} is a sub-module: only the stacked HexCNN "
                    "route (HexConvStack stages) converts")
            out[f"{name}.{leaf}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    head = tree["head"]
    out["head.weight"] = torch.from_numpy(
        np.array(head["kernel"], dtype=np.float32).T.copy())
    out["head.bias"] = torch.from_numpy(np.array(head["bias"], dtype=np.float32))
    return out
