"""The port's collectives over ``torch.distributed``, and their counts.

Every message the ``parallel`` package sends goes through these helpers:
point-to-point exchanges posted together (``dist.batch_isend_irecv``),
all-reduces and broadcasts.  On an NCCL group they move CUDA tensors as
they are.  Gloo's ``send``/``recv`` take CPU tensors only, so on a gloo
group the message (never the compute) goes through host memory: that is
the transport the backend needs, chosen by the group's backend.

``COUNTS`` counts what was called since :func:`reset_counts`: ``send`` and
``recv`` messages, ``all_reduce`` and ``broadcast`` calls, and the bytes
sent point to point (``p2p_bytes``).  ``chip_smoke.py`` reads them beside
the kernels' launch counters.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

COUNTS = {"send": 0, "recv": 0, "all_reduce": 0, "broadcast": 0,
          "p2p_bytes": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _through_host(group, tensor: torch.Tensor) -> bool:
    """Whether a message of ``tensor`` on ``group`` is staged in host memory
    (a CUDA tensor on a gloo group)."""
    return (tensor.device.type != "cpu"
            and dist.get_backend(group) == dist.Backend.GLOO)


def group_ranks(group) -> List[int]:
    """The global ranks of ``group``, in group-rank order."""
    return dist.get_process_group_ranks(group)


def exchange(group, sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[tuple, int]], like: torch.Tensor
             ) -> List[torch.Tensor]:
    """Post every send ``(tensor, global peer)`` and every receive
    ``(shape, global peer)`` of one round together, wait for all, and return
    the received tensors (``like``'s dtype and device), in ``recvs``'
    order."""
    staged = _through_host(group, like)
    wire = torch.device("cpu") if staged else like.device
    out = [torch.empty(shape, dtype=like.dtype, device=wire)
           for shape, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.detach().to(wire).contiguous(), peer,
                      group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, group)
            for buf, (_, peer) in zip(out, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    COUNTS["send"] += len(sends)
    COUNTS["recv"] += len(recvs)
    COUNTS["p2p_bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
    return [t.to(like.device) for t in out] if staged else out


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; returns it."""
    if _through_host(group, tensor):
        host = tensor.detach().cpu()
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    COUNTS["all_reduce"] += 1
    return tensor


def broadcast_(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """Overwrite ``tensor`` in place with global rank ``src``'s copy, over
    the default group."""
    if _through_host(None, tensor):
        host = tensor.detach().cpu()
        dist.broadcast(host, src)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src)
    COUNTS["broadcast"] += 1
    return tensor


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over a group of terms that differ by rank (each
    rank's loss depends on the sum): the backward sums the cotangents too,
    as ``psum`` transposes for a varying cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class AllReduceReplicated(torch.autograd.Function):
    """Sum over a group whose result every rank then uses alike (a
    replicated output, one loss computed on every rank): the cotangent is
    the same on every rank and passes back unchanged, as ``psum`` to an
    unmapped output transposes under ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def average_grads_(params, group) -> None:
    """Average the ``.grad`` of ``params`` over ``group``: one all-reduce a
    dtype, of the grads flattened into one buffer."""
    size = dist.get_world_size(group)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, group)
        flat /= size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
