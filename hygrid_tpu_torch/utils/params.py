"""Weight conversion from ``hygrid_tpu``'s flax variables to the port's
``state_dict``s.  Takes plain nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, variables)``, or
:func:`flax_tree_from_npz` of a checkpoint ``hygrid_tpu.utils.save_checkpoint``
wrote) and imports no JAX."""
from __future__ import annotations

import ast
import re
from collections import OrderedDict
from typing import Mapping, Union

import numpy as np
import torch

__all__ = ["hexcnn_state_dict_from_flax", "hexconvmodule_state_dict_from_flax",
           "hexunet_state_dict_from_flax", "hexvit_state_dict_from_flax",
           "hexresnet_state_dict_from_flax",
           "hexconvnext_state_dict_from_flax", "flax_tree_from_npz"]

# flax norm submodule (inside HexConvModule's "norm") -> torch names
_NORM_LEAVES = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]")


def flax_tree_from_npz(source: Union[str, Mapping]) -> dict:
    """The nested dict of numpy arrays behind a flat ``.npz`` checkpoint
    (a path, or the mapping ``np.load`` gives), whose keys are
    ``jax.tree_util.keystr`` paths such as ``['params']['head']['kernel']``:
    what ``hygrid_tpu.utils.save_checkpoint`` writes of flax variables.
    Feed the result to the ``*_state_dict_from_flax`` converters."""
    if isinstance(source, str):
        with np.load(source) as data:
            flat = {k: data[k] for k in data.files}
    else:
        flat = dict(source)
    tree: dict = {}
    for key, value in flat.items():
        parts = [ast.literal_eval(m) for m in _KEY.findall(key)]
        if not parts or "".join(f"[{p!r}]" for p in parts) != key:
            raise ValueError(f"{key!r} is not a keystr path")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def _t(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def hexconvmodule_state_dict_from_flax(variables: Mapping, prefix: str = ""
                                       ) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.nn.modules.HexConvModule`
    from the flax variables ``{"params": ..., "batch_stats": ...}`` of
    ``hygrid_tpu.nn.modules.HexConvModule`` (``batch_stats`` optional),
    each key prefixed by ``prefix``.

    ``conv/kernel`` and ``conv/bias`` keep their names; under spectral norm
    ``conv/layer_instance/*`` becomes ``conv.layer_instance.*`` and the
    ``batch_stats`` ``conv/layer_instance/kernel/u`` and ``.../sigma``
    become the buffers ``conv.kernel_u`` and ``conv.kernel_sigma``.  The
    norm's ``scale``/``bias`` (under ``BatchNorm_0``, ``GroupNorm_0``,
    ``LayerNorm_0`` or, for IN, directly under ``norm``) become
    ``norm.weight``/``norm.bias``, BN's ``mean``/``var`` the buffers
    ``norm.running_mean``/``norm.running_var``; PReLU's
    ``activate/negative_slope`` keeps its name.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    conv = params["conv"]
    if "layer_instance" in conv:
        for leaf, value in sorted(conv["layer_instance"].items()):
            out[f"{prefix}conv.layer_instance.{leaf}"] = _t(value)
        for key, value in sorted(stats["conv"].items()):
            _, pname, what = key.split("/")      # layer_instance/kernel/u
            out[f"{prefix}conv.{pname}_{what}"] = _t(value)
    else:
        for leaf, value in sorted(conv.items()):
            out[f"{prefix}conv.{leaf}"] = _t(value)
    if "norm" in params or "norm" in stats:
        norm = params.get("norm", {})
        inner = next((k for k in norm if isinstance(norm[k], Mapping)), None)
        leaves = norm[inner] if inner else norm
        for leaf, value in sorted(leaves.items()):
            out[f"{prefix}norm.{_NORM_LEAVES[leaf]}"] = _t(value)
        bn = stats.get("norm", {}).get("BatchNorm_0", {})
        for leaf, value in sorted(bn.items()):
            out[f"{prefix}norm.{_BN_STATS[leaf]}"] = _t(value)
    if "activate" in params:
        out[f"{prefix}activate.negative_slope"] = _t(
            params["activate"]["negative_slope"])
    return out


def _dense(out, name, dense: Mapping) -> None:
    """A flax ``Dense`` (``kernel`` ``(in, out)``, ``bias``) as torch
    ``Linear`` leaves ``{name}.weight`` ``(out, in)`` and ``{name}.bias``."""
    out[f"{name}.weight"] = torch.from_numpy(
        np.array(dense["kernel"], dtype=np.float32).T.copy())
    out[f"{name}.bias"] = _t(dense["bias"])


def _split_variables(tree: Mapping):
    """``(params, batch_stats)`` from the ``params`` tree itself,
    ``{"params": tree}`` or ``{"params": tree, "batch_stats": stats}``."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def _conv_stage(out, name, sub: Mapping, stats: Mapping) -> None:
    """A stacked stage's leaves (``kernel_{i}``, ``bias_{i}``,
    ``gn_scale_{i}``, ``gn_bias_{i}``) keep their names; a
    ``HexConvModule`` bundle goes through
    :func:`hexconvmodule_state_dict_from_flax` with its ``batch_stats``."""
    if any(isinstance(v, Mapping) for v in sub.values()):
        out.update(hexconvmodule_state_dict_from_flax(
            {"params": sub, "batch_stats": stats.get(name, {})},
            prefix=f"{name}."))
        return
    for leaf, value in sorted(sub.items()):
        out[f"{name}.{leaf}"] = _t(value)


def hexcnn_state_dict_from_flax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexCNN` from the
    flax variables of ``hygrid_tpu.models.HexCNN``.

    Accepts the ``params`` tree itself, ``{"params": tree}`` or
    ``{"params": tree, "batch_stats": stats}``.  Stacked stages keep their
    leaves' names (``stage{s}/kernel_{i}`` -> ``stage{s}.kernel_{i}``,
    likewise ``bias_{i}``, ``gn_scale_{i}``, ``gn_bias_{i}``); a
    ``HexConvModule`` bundle ``stage{s}_conv{d}`` goes through
    :func:`hexconvmodule_state_dict_from_flax` with its ``batch_stats``;
    the Dense ``head/kernel`` ``(in, out)`` becomes ``head.weight``
    ``(out, in)``.
    """
    tree, stats = _split_variables(tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in sorted(k for k in tree if k.startswith("stage")):
        _conv_stage(out, name, tree[name], stats)
    _dense(out, "head", tree["head"])
    return out


def hexunet_state_dict_from_flax(tree: Mapping
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexUNet` from the
    flax variables of ``hygrid_tpu.models.HexUNet`` (its stage-wise and
    packed routes share one tree).

    Accepts what :func:`hexcnn_state_dict_from_flax` accepts.  Stacked
    stages ``enc{i}`` / ``dec{i}`` keep their leaves' names; bundles
    ``enc{i}_conv{d}`` / ``dec{i}_conv{d}`` go through
    :func:`hexconvmodule_state_dict_from_flax` with their ``batch_stats``;
    a transposed conv ``up{i}`` keeps ``kernel`` ``(O, C, kn)`` (and
    ``bias``) as they are; a pixel-shuffle ``up{i}``'s ``Dense_0`` becomes
    ``up{i}.expand`` and the ``head`` Dense ``head``, each ``kernel`` ``(in,
    out)`` as ``weight`` ``(out, in)``.
    """
    tree, stats = _split_variables(tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in sorted(tree):
        sub = tree[name]
        if name == "head":
            _dense(out, "head", sub)
        elif name.startswith("up"):
            if "Dense_0" in sub:
                _dense(out, f"{name}.expand", sub["Dense_0"])
            else:
                for leaf, value in sorted(sub.items()):
                    out[f"{name}.{leaf}"] = _t(value)
        else:
            _conv_stage(out, name, sub, stats)
    return out


def _norm(out, name, norm: Mapping) -> None:
    """A flax ``LayerNorm`` / ``GroupNorm`` (``scale``, ``bias``) as torch
    ``{name}.weight`` and ``{name}.bias``."""
    out[f"{name}.weight"] = _t(norm["scale"])
    out[f"{name}.bias"] = _t(norm["bias"])


def hexvit_state_dict_from_flax(tree: Mapping
                                ) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexViT` from the
    flax variables of ``hygrid_tpu.models.HexViT``.

    Accepts what :func:`hexcnn_state_dict_from_flax` accepts.  The stem
    convs ``stem{i}`` and ``pos_embedding`` keep their names; in each
    ``block{i}`` the LayerNorms ``LayerNorm_0`` / ``LayerNorm_1`` become
    ``ln1`` / ``ln2`` and the Dense ``Dense_0`` / ``Dense_1`` ``fc1`` /
    ``fc2``; the attention's ``query``, ``key`` and ``value`` kernels
    ``(dim, heads, head_dim)`` become ``attn.{name}.weight`` ``(heads *
    head_dim, dim)`` (biases flattened), its ``out`` kernel ``(heads,
    head_dim, dim)`` ``attn.out.weight`` ``(dim, heads * head_dim)``; the
    final ``LayerNorm_0`` becomes ``norm`` and the Dense ``head`` ``head``.
    """
    tree, _ = _split_variables(tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in sorted(tree):
        sub = tree[name]
        if name == "pos_embedding":
            out[name] = _t(sub)
        elif name.startswith("stem"):
            for leaf, value in sorted(sub.items()):
                out[f"{name}.{leaf}"] = _t(value)
        elif name.startswith("block"):
            _norm(out, f"{name}.ln1", sub["LayerNorm_0"])
            _norm(out, f"{name}.ln2", sub["LayerNorm_1"])
            _dense(out, f"{name}.fc1", sub["Dense_0"])
            _dense(out, f"{name}.fc2", sub["Dense_1"])
            for proj, dense in sorted(sub["attn"].items()):
                kernel = np.array(dense["kernel"], dtype=np.float32)
                d = kernel.shape[-1] if proj == "out" else kernel.shape[0]
                _dense(out, f"{name}.attn.{proj}", {
                    "kernel": kernel.reshape(-1, d) if proj == "out"
                    else kernel.reshape(d, -1),
                    "bias": np.reshape(dense["bias"], -1)})
        elif name == "LayerNorm_0":
            _norm(out, "norm", sub)
        else:
            _dense(out, name, sub)
    return out


def hexconvnext_state_dict_from_flax(tree: Mapping, prefix: str = ""
                                     ) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexConvNeXtBlock`
    from the flax variables of ``hygrid_tpu.models.HexConvNeXtBlock``
    (what :func:`hexcnn_state_dict_from_flax` accepts), each key prefixed
    by ``prefix``: ``dw_kernel`` keeps its name, ``LayerNorm_0`` becomes
    ``norm``, ``Dense_0`` / ``Dense_1`` ``fc1`` / ``fc2``."""
    tree, _ = _split_variables(tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    out[f"{prefix}dw_kernel"] = _t(tree["dw_kernel"])
    _norm(out, f"{prefix}norm", tree["LayerNorm_0"])
    _dense(out, f"{prefix}fc1", tree["Dense_0"])
    _dense(out, f"{prefix}fc2", tree["Dense_1"])
    return out


def hexresnet_state_dict_from_flax(tree: Mapping
                                   ) -> "OrderedDict[str, torch.Tensor]":
    """``state_dict`` of :class:`hygrid_tpu_torch.models.HexResNet` from the
    flax variables of ``hygrid_tpu.models.HexResNet`` (what
    :func:`hexcnn_state_dict_from_flax` accepts).  In each block
    ``s{i}b{j}`` the GroupNorms ``gn1`` / ``gn2`` keep their names
    (``scale`` -> ``weight``), the kernels ``k1`` / ``k2`` theirs, and the
    Dense ``proj`` becomes ``proj``; so does the ``head``.  A bare
    :class:`HexResBlock`'s tree converts as one block with an empty
    name."""
    tree, _ = _split_variables(tree)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    blocks = {k: v for k, v in tree.items() if k != "head"}
    if "k1" in tree:
        blocks = {"": tree}
    for name in sorted(blocks):
        sub, pre = blocks[name], f"{name}." if name else ""
        for gn in ("gn1", "gn2"):
            _norm(out, f"{pre}{gn}", sub[gn])
        for k in ("k1", "k2"):
            out[f"{pre}{k}"] = _t(sub[k])
        if "proj" in sub:
            _dense(out, f"{pre}proj", sub["proj"])
    if "head" in tree:
        _dense(out, "head", tree["head"])
    return out
