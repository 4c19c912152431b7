"""Ahead-of-time model export for serving, on ``torch.export`` (port of
``hygrid_tpu/utils/export.py``).

A trained hex model exports to one file: the traced graph with its
parameters and the resample plans' tables as constants.  A server loads it
and runs inference with no model code and no parameter files:
``load_exported(path)`` and a batch of images.

- **The kernels stay in the program.** Every forward kernel of the port is
  an op of the ``hygrid`` namespace (``kernels/_ops.py``), kept as one node
  of the exported graph: the loaded program launches the same CUDA kernels
  as the eager model on a CUDA input, and runs their plain versions on a
  CPU one.  Loading needs ``import hygrid_tpu_torch``, which registers the
  ops (the reference's artifact needs only jax).
- **Symbolic batch** (``symbolic_batch=True``): the leading axis of every
  example input is one shared ``torch.export.Dim``, so one artifact serves
  any batch size.  Spatial dims stay concrete: the resample plans are
  host data built for one size.
- **Platforms**: ``platforms`` names the device types the artifact is meant
  for (default: the example inputs' device type); :func:`save_exported`
  stores them in the file and :func:`load_exported` refuses to move the
  program to another.  Unlike the reference's argument it picks no
  lowering: the ops choose their implementation by the device of the
  tensors at run time, so a program runs where its constants are, and
  ``load_exported(path, device=...)`` moves them.

Round trip: :func:`export_fn` -> :func:`save_exported` ->
:func:`load_exported` -> call.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import re
from typing import Any, Callable, Optional, Sequence

import torch
from torch.export.passes import move_to_device_pass
from torch.utils import _pytree as pytree

__all__ = ["Exported", "export_fn", "export_inference", "save_exported",
           "load_exported", "exported_info"]

_META = "hygrid_export.json"


@dataclasses.dataclass(frozen=True)
class Exported:
    """An exported program and the device types it is meant for."""
    program: torch.export.ExportedProgram
    platforms: tuple


class _Closure(torch.nn.Module):
    """``fn(close_over, *args)`` (``fn(*args)`` without ``close_over``) as a
    module: a module ``close_over`` is a submodule (its parameters and
    buffers go into the program's state), any other pytree is kept as
    tensors, which the export lifts as constants."""

    def __init__(self, fn: Callable, close_over: Any):
        super().__init__()
        self.fn = fn
        if close_over is None or isinstance(close_over, torch.nn.Module):
            self.const = close_over
        else:
            self.const = pytree.tree_map(torch.as_tensor, close_over)

    def forward(self, *args):
        if self.const is None:
            return self.fn(*args)
        return self.fn(self.const, *args)


def _symbolic(args: tuple, symbolic_batch: bool):
    """``(trace_args, dynamic_shapes)`` for ``torch.export``: ``args`` and
    None, or one shared ``Dim("b")`` on the leading axis of every tensor.
    ``torch.export`` specialises a dim of size 1, so a batch of one is
    traced on the examples repeated to a batch of two (the program is the
    same for every batch)."""
    if not symbolic_batch:
        return args, None
    leaves = [a for a in pytree.tree_leaves(args) if torch.is_tensor(a)]
    batches = {int(a.shape[0]) for a in leaves}
    if len(batches) != 1:
        raise ValueError(
            f"symbolic_batch requires one shared leading dim; got {batches}")
    if batches == {1}:
        args = pytree.tree_map(
            lambda a: a.expand(2, *a.shape[1:]).contiguous()
            if torch.is_tensor(a) else a, args)
    b = torch.export.Dim("b")
    # one entry: the module's forward takes the examples as *args
    return args, (pytree.tree_map(
        lambda a: {0: b} if torch.is_tensor(a) else None, args),)


def export_fn(fn: Callable, example_args: Sequence[Any], *,
              close_over: Any = None, symbolic_batch: bool = False,
              platforms: Optional[Sequence[str]] = None) -> Exported:
    """Export ``fn(close_over, *example_args)`` (or ``fn(*example_args)``
    when ``close_over`` is None) with ``torch.export``.

    ``close_over`` (a module, or a pytree of tensors such as a state dict)
    is captured by value: it becomes the program's state or constants.
    ``example_args`` fix the input shapes and dtypes (the leading axis
    symbolic when ``symbolic_batch``).  ``platforms`` defaults to the
    example inputs' device type (see the module note).

    ``fn`` runs once eagerly on the traced examples before the trace, so
    that the plans and kernel tables it builds are cached as real tensors
    (built inside the trace, the caches would keep fake ones); then it is
    traced without autograd (inference only).
    """
    args = tuple(example_args)
    module = _Closure(fn, close_over)
    trace_args, dynamic = _symbolic(args, symbolic_batch)
    if platforms is None:
        platforms = sorted({a.device.type for a in pytree.tree_leaves(args)
                            if torch.is_tensor(a)} or {"cpu"})
    with torch.no_grad():
        module(*trace_args)
        program = torch.export.export(module, trace_args,
                                      dynamic_shapes=dynamic, strict=False)
    # the artifact keeps no copy of the examples (a b=32 512^2 bf16 batch
    # is 50 MB, a hundred times the model)
    program.example_inputs = None
    return Exported(program, tuple(p.lower() for p in platforms))


def export_inference(model: torch.nn.Module, params, example_input, *,
                     hexify: bool = True, symbolic_batch: bool = False,
                     platforms: Optional[Sequence[str]] = None,
                     **apply_kwargs) -> Exported:
    """Export a hex model's inference path, its parameters baked in.

    ``params`` is a state dict loaded into a copy of ``model`` (None: the
    model's own); the copy runs in eval mode.  ``example_input`` is a rect
    image batch ``(B, C, H, W)`` when ``hexify`` (the program embeds the
    rect->hex resample plan's tables: callers feed plain camera or file
    pixels), else an already-hex batch.  ``apply_kwargs`` go to the
    model's ``forward``.
    """
    from ..models.train import hexify_batch

    model = copy.deepcopy(model)
    if params is not None:
        model.load_state_dict(params)
    model.eval().requires_grad_(False)

    def infer(m, x):
        if hexify:
            x = hexify_batch(x)
        return m(x, **apply_kwargs)

    return export_fn(infer, (example_input,), close_over=model,
                     symbolic_batch=symbolic_batch, platforms=platforms)


def save_exported(path: str, exported: Exported) -> None:
    """Serialize an :func:`export_fn` artifact to one file
    (``torch.export.save``, the platforms in its extra files)."""
    torch.export.save(exported.program, path, extra_files={
        _META: json.dumps({"platforms": list(exported.platforms)})})


def _load(path: str):
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    return program, json.loads(extra[_META])


def load_exported(path: str, device=None) -> Callable:
    """Load a :func:`save_exported` artifact as a callable module
    (``ExportedProgram.module()``).

    ``device`` moves the program's state and constants there first
    (``move_to_device_pass``); a device type outside the artifact's
    platforms raises ``ValueError``.  Needs ``import hygrid_tpu_torch``
    (done here), which registers the ``hygrid`` ops: no model code, no
    parameter files.
    """
    program, meta = _load(path)
    if device is not None:
        device = torch.device(device)
        if device.type not in meta["platforms"]:
            raise ValueError(f"{path} was exported for {meta['platforms']}, "
                             f"not {device.type}")
        program = move_to_device_pass(program, device)
    return program.module()


def _aval(val, names: dict) -> str:
    """``dtype[d0,d1,...]`` of a traced value, symbolic dims by name."""
    dims = [re.sub(r"\bs\d+\b", lambda m: names.get(m.group(0), m.group(0)),
                   str(d)) for d in val.shape]
    return f"{str(val.dtype).removeprefix('torch.')}[{','.join(dims)}]"


def exported_info(path: str) -> dict:
    """Inspect an artifact: platforms, input and output shapes and dtypes
    (``in_avals``, ``out_avals``; the symbolic batch as ``b``) and the
    number of devices the program runs on."""
    program, meta = _load(path)
    sig = program.graph_signature
    vals = {n.name: n.meta.get("val") for n in program.graph.nodes}
    user_in = [vals[name] for name in sig.user_inputs]
    names = {str(v.shape[0]): "b" for v in user_in
             if torch.is_tensor(v) and v.ndim
             and not isinstance(v.shape[0], int)}
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outs = [a.meta.get("val") for a in pytree.tree_leaves(out_node.args)]
    return {
        "platforms": list(meta["platforms"]),
        "in_avals": [_aval(v, names) for v in user_in],
        "out_avals": [_aval(v, names) for v in outs[-len(sig.user_outputs):]],
        "nr_devices": 1,
    }
