"""Checkpoint and resume, PyTorch port of ``hygrid_tpu/utils/checkpoint.py``.

* ``.npz``: flat numpy arrays keyed by the reference's
  ``jax.tree_util.keystr`` paths (``['stage0.kernel_0']`` for a module's
  ``state_dict`` entry, ``['params']['Conv_0']['kernel']`` in a flax tree),
  as ``hygrid_tpu`` writes them; bfloat16 leaves are stored as float32 and
  cast back to the target's dtype on restore.
* Any other path: one ``torch.save`` file of a module's ``state_dict``, or
  of a :class:`~hygrid_tpu_torch.models.train.TrainState`'s model and
  optimizer ``state_dict`` and its ``step``.

A ``.npz`` that ``hygrid_tpu.utils.save_checkpoint`` wrote of flax
variables reads back as the nested dict with
:func:`hygrid_tpu_torch.utils.params.flax_tree_from_npz`, which the
``*_state_dict_from_flax`` converters take.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "HAS_ORBAX"]

#: There is no orbax beside PyTorch: directory checkpoints are never
#: written.  The name stays so that imports port unchanged.
HAS_ORBAX = False


def _is_state(tree) -> bool:
    return hasattr(tree, "model") and hasattr(tree, "optimizer")


def _flatten(tree, prefix: str = "") -> dict:
    """``{keystr path: numpy leaf}`` of a module, a dict/list/tuple tree of
    tensors, arrays or scalars."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
        return out
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {prefix: t.numpy()}
    return {prefix: np.asarray(tree)}


def _is_npz(path: str) -> bool:
    return path.endswith(".npz") or (not os.path.exists(path)
                                     and os.path.exists(path + ".npz"))


def save_checkpoint(path: str, tree: Any, *, force: bool = False) -> None:
    """Save ``tree`` to ``path``: a flat ``.npz`` when the path ends in
    ``.npz``, else one ``torch.save`` file (an existing file is
    overwritten only with ``force=True``)."""
    if path.endswith(".npz"):
        np.savez(path, **_flatten(tree))
        return
    if os.path.exists(path) and not force:
        raise FileExistsError(f"{path} exists; pass force=True to "
                              "overwrite it")
    if _is_state(tree):
        payload = {"model": tree.model.state_dict(),
                   "optimizer": tree.optimizer.state_dict(),
                   "step": tree.step}
    elif isinstance(tree, torch.nn.Module):
        payload = {"model": tree.state_dict()}
    else:
        payload = tree
    torch.save(payload, path)


def _load_module(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """Copy ``flat`` (keystr of ``state_dict`` names -> arrays) into
    ``module``: every entry must name one of its tensors, and every
    parameter must have an entry (buffers may be absent, as in a
    params-only checkpoint)."""
    own = module.state_dict()
    by_key = {f"[{k!r}]": k for k in own}
    unknown = sorted(set(flat) - set(by_key))
    if unknown:
        raise KeyError(f"checkpoint entries not in the module: {unknown[:5]}")
    missing = sorted(f"[{n!r}]" for n, _ in module.named_parameters()
                     if f"[{n!r}]" not in flat)
    if missing:
        raise KeyError(f"parameters missing from the checkpoint: "
                       f"{missing[:5]}")
    with torch.no_grad():
        for key, value in flat.items():
            dst = own[by_key[key]]
            dst.copy_(torch.from_numpy(np.asarray(value)).to(dst.dtype))
    return module


def _unflatten_like(target, flat: dict, prefix: str = ""):
    if isinstance(target, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}[{k!r}]")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(v, flat, f"{prefix}[{i}]")
                            for i, v in enumerate(target))
    value = flat[prefix]
    if torch.is_tensor(target):
        return torch.from_numpy(np.asarray(value)).to(target.device,
                                                      target.dtype)
    return value


def restore_checkpoint(path: str, target: Optional[Any] = None):
    """Restore a checkpoint written by :func:`save_checkpoint`.

    ``.npz``: without ``target`` the flat ``{keystr: array}`` dict; a
    module ``target`` is loaded in place and returned; a dict/list
    ``target`` gives a tree of its structure (tensors on the target
    leaves' device and dtype).  A ``torch.save`` file: loaded into a
    ``TrainState`` or module ``target`` in place (returned), else returned
    as it was saved.
    """
    if _is_npz(path):
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        if target is None:
            return flat
        if isinstance(target, torch.nn.Module):
            return _load_module(target, flat)
        return _unflatten_like(target, flat)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return payload
    if _is_state(target):
        target.model.load_state_dict(payload["model"])
        target.optimizer.load_state_dict(payload["optimizer"])
        target.step = payload["step"]
        return target
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(payload["model"])
        return target
    raise TypeError(f"cannot restore a torch.save checkpoint into "
                    f"{type(target).__name__}")
