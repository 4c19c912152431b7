"""Process meshes over ``torch.distributed``, PyTorch port of
``hygrid_tpu/parallel/mesh.py``.

``hygrid_tpu`` lays devices out in a ``jax.sharding.Mesh`` and lets
``shard_map`` hand each device its block.  Here each rank of the default
process group is one mesh position: :func:`create_mesh` lays the ranks out
row-major over the named axes and makes the process group along each axis,
and every sharded function takes and returns **this rank's shard**.  The
axis vocabulary is the reference's:

* ``"dp"`` — data parallel (batch axis);
* ``"sp"`` — spatial parallel (image rows, :mod:`.spatial`);
* ``"pp"`` — pipeline stages (:mod:`.pipeline`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import _comm

__all__ = ["P", "Mesh", "create_mesh", "shard_batch", "replicate",
           "batch_spec", "spatial_spec"]


class P(tuple):
    """``PartitionSpec``'s counterpart: one mesh axis name (or ``None``) per
    array dimension, ``P("dp", None, "sp", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh:
    """The default process group's ranks laid out row-major over named axes.

    Attributes:
        shape: ``{axis name: size}``, as ``jax.sharding.Mesh.shape`` reads.
        axis_names: the names in order.
        ranks: numpy array of global ranks, one per mesh position.
        coords: ``{axis name: this rank's index along it}``.
    """

    def __init__(self, axes: Dict[str, int]):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        sizes = tuple(int(s) for s in axes.values())
        self.ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
        rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(
                                   self.ranks == rank)[0])))
        self._groups: Dict[str, object] = {}
        # dist.new_group is collective: every rank makes every group, in
        # the same order, and keeps the one it belongs to
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, a, -1).reshape(-1, sizes[a])
            for line in lines:
                group = dist.new_group(line.tolist())
                if rank in line:
                    self._groups[name] = group

    def group(self, axis_name: str):
        """This rank's process group along ``axis_name``."""
        return self._groups[axis_name]

    def group_ranks(self, axis_name: str) -> List[int]:
        """The global ranks of this rank's group along ``axis_name``, in
        axis order."""
        return _comm.group_ranks(self._groups[axis_name])

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def create_mesh(axes: Dict[str, int]) -> Mesh:
    """Lay the default process group's ranks out over ``axes``, e.g.
    ``create_mesh({"dp": 2, "sp": 2})``, row-major (rank ``r`` sits at
    ``np.unravel_index(r, sizes)``, as ``mesh_utils.create_device_mesh``
    orders the CPU devices of ``hygrid_tpu``'s tests).

    Needs an initialised default process group whose world size is the
    mesh's size; every rank must call it, in the same order as its other
    group creations.  A rank computes on its tensors' device (there is no
    ``devices=``).
    """
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group or "
                           "parallel.initialize_multihost)")
    n = int(np.prod(list(axes.values())))
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {axes} needs {n} ranks, the world has "
                         f"{world}")
    return Mesh(axes)


def batch_spec(mesh: Mesh, ndim: int = 4, axis: str = "dp") -> P:
    """Spec sharding the leading (batch) dim of an ndim array."""
    return P(*((axis,) + (None,) * (ndim - 1)))


def spatial_spec(mesh: Mesh, ndim: int = 4, batch_axis: str = "dp",
                 row_axis: str = "sp") -> P:
    """Shard batch over dp and image rows over sp for (B, C, H, W)."""
    spec = [None] * ndim
    spec[0] = batch_axis
    spec[-2] = row_axis
    return P(*spec)


def shard_batch(x, mesh: Mesh, spec: Optional[P] = None, *, device="cuda"):
    """This rank's shard of the global array ``x`` (default spec: the batch
    axis over ``"dp"``).

    A dim named in ``spec`` is cut into ``mesh.shape[axis]`` equal blocks
    and the block at this rank's coordinate is returned.  Image rows (dim
    -2) are zero-padded at the bottom to a multiple of twice the axis
    size and columns (dim -1) at the right to a multiple of it, as
    ``hygrid_tpu/parallel/spatial.py:311-314`` pads them, so every row
    slab has an even height and starts on an even hex row; any other dim
    must divide.  A spec axis absent from the mesh (``"dp"`` of
    :func:`spatial_spec` on an ``{"sp": n}`` mesh) leaves the dim whole.
    A tensor stays on its device; other input goes to ``device``.
    """
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x),
                                                     device=device)
    spec = spec if spec is not None else batch_spec(mesh, x.ndim)
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} does not match a {x.ndim}-d array")
    pad = [0] * (2 * x.ndim)           # F.pad order: last dim first
    blocks = []
    for d, axis in enumerate(spec):
        if axis is None or axis not in mesh.shape:
            continue
        n, size = mesh.shape[axis], x.shape[d]
        if d == x.ndim - 2:
            full = -(-size // (2 * n)) * 2 * n
        elif d == x.ndim - 1:
            full = -(-size // n) * n
        elif size % n:
            raise ValueError(f"dim {d} of size {size} does not split over "
                             f"{n} ranks of {axis!r}")
        else:
            full = size
        pad[2 * (x.ndim - 1 - d) + 1] = full - size
        blocks.append((d, full // n, mesh.coords[axis]))
    if any(pad):
        x = torch.nn.functional.pad(x, pad)
    for d, block, i in blocks:
        x = x.narrow(d, i * block, block)
    return x.contiguous()


def replicate(tree, mesh: Mesh):
    """Make rank 0's copy everyone's: broadcast a module's parameters and
    buffers, a tensor, or a dict/list of tensors, in place, over the mesh
    (the whole default group).  Returns ``tree``."""
    src = int(mesh.ranks.flat[0])
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif torch.is_tensor(tree):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            _comm.broadcast_(t, src)
    return tree
