"""Pipeline parallelism: a GPipe microbatched stage pipeline over the
``"pp"`` ranks, PyTorch port of ``hygrid_tpu/parallel/pipeline.py``.

Each rank of the ``pp`` group runs one stage.  The schedule is the
reference's fill-drain: with S stages and M microbatches it runs
T = M + S - 1 ticks; on every tick each rank computes its stage (idle ticks
compute on placeholder data whose results are never consumed) and the
activations hop one rank along the ring by send/recv.  The last stage's
outputs are summed over the group, masked to that stage, so every rank
returns the whole result.  The schedule is differentiable, as the
reference's ``lax.scan`` is: the ring hop is an ``autograd.Function``
whose backward sends the cotangent back along the ring.

Constraints (inherent to the schedule): every stage maps activations of
one shape and dtype to the same; stage parameters are a tree whose leaves
carry a leading ``num_stages`` axis (:func:`stack_stage_params`).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from . import _comm
from ..nn import functional as F

__all__ = ["stack_stage_params", "pipeline_apply", "pipeline_hex_conv_stack"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def stack_stage_params(stage_params_list):
    """Stack a list of per-stage parameter trees (dicts, lists or tuples of
    tensors) into one tree whose leaves have a leading ``num_stages``
    axis."""
    return _tree_map(lambda *leaves: torch.stack(
        [torch.as_tensor(v) for v in leaves]), *stage_params_list)


class _RingHop(torch.autograd.Function):
    """Send ``y`` to the next rank of the ring and return what the previous
    rank sent; the backward sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.ring = (group, nxt, prv)
        return _comm.exchange(group, [(y, nxt)], [(tuple(y.shape), prv)],
                              y)[0]

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.ring
        return (_comm.exchange(group, [(g, prv)], [(tuple(g.shape), nxt)],
                               g)[0], None, None, None)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params, x: torch.Tensor, mesh, *, microbatches: int,
                   axis_name: str = "pp"):
    """Run ``x`` through ``num_stages`` sequential stages pipelined over the
    ``axis_name`` ranks.

    ``stage_fn(params_for_one_stage, microbatch) -> microbatch``;
    ``stage_params`` leaves have a leading dim of ``mesh.shape[axis_name]``
    and this rank uses its own index.  ``x`` is the global batch ``(B,
    ...)``, the same on every rank, split into ``microbatches`` equal
    microbatches.  Returns ``stage_fn(p[S-1], ... stage_fn(p[0], x))`` on
    every rank of the group.

    Differentiable: with the same loss computed on every rank from the
    result, each rank's backward gives its own stage's parameter grads
    (the other stages' slices of a stacked leaf get zeros).
    """
    S = mesh.shape[axis_name]
    B = x.shape[0]
    M = int(microbatches)
    if M < 1 or B % M:
        raise ValueError(f"batch {B} must split into {M} equal microbatches")
    if M < S:
        raise ValueError(f"need microbatches >= stages ({S}); got {M}")
    mb = B // M
    xm = x.reshape((M, mb) + tuple(x.shape[1:]))
    group = mesh.group(axis_name)
    ranks = mesh.group_ranks(axis_name)
    idx = mesh.coords[axis_name]
    nxt, prv = ranks[(idx + 1) % S], ranks[(idx - 1) % S]
    params = _tree_map(lambda a: a[idx], stage_params)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)

    carry = torch.zeros_like(xm[0])
    ys = []
    for t in range(M + S - 1):
        feed = min(t, M - 1)          # clamp drain-phase reads
        # where(), not a branch: stage 0's carry gets a zero cotangent, so
        # every rank's backward runs every ring hop, in the same order
        inp = torch.where(first, xm[feed], carry)
        y = stage_fn(params, inp)
        carry = _RingHop.apply(y, group, nxt, prv) if S > 1 else y
        ys.append(y)
    # the last stage emits microbatch m at tick m + S - 1; earlier ticks
    # (its fill phase) and other stages' outputs are never consumed
    out = torch.stack(ys[S - 1:])
    out = torch.where(last, out, torch.zeros_like(out))
    if S > 1:
        out = _comm.AllReduceReplicated.apply(out, group)
    return out.reshape((B,) + tuple(out.shape[2:]))


def pipeline_hex_conv_stack(x: torch.Tensor, kernels, mesh, *, radius: int,
                            even_odd_offset: int = 0,
                            microbatches: Optional[int] = None,
                            axis_name: str = "pp",
                            activation: Optional[Callable] = None):
    """Pipeline a uniform-width 'same' hex-conv stack over the ``pp`` ranks.

    ``kernels``: ``(L, C, C, kernelnum)``; L must split into
    ``mesh.shape[axis_name]`` equal stages, each applying its L/S layers
    (each followed by ``activation`` when given).  Equal to the L convs
    ``hex_conv2d(..., padding=radius-1)`` applied in sequence on one
    device.
    """
    if even_odd_offset:
        # every framework op outputs offset 0, so a uniform per-layer stage
        # is only correct for offset-0 input
        raise ValueError("pipeline_hex_conv_stack requires even_odd_offset=0 "
                         "(all framework ops output offset 0)")
    kernels = torch.as_tensor(kernels)
    L = kernels.shape[0]
    S = mesh.shape[axis_name]
    if L % S:
        raise ValueError(
            f"stage count {S} must divide the layer count {L}")
    per = L // S
    if microbatches is None:
        # GPipe bubble is (S-1)/(M+S-1): aim for M ~ 4S while keeping
        # microbatches as large as possible; among divisors of B that are
        # >= S, take the one nearest 4S
        B = x.shape[0]
        divs = [m for m in range(1, B + 1) if B % m == 0 and m >= S]
        if not divs:
            raise ValueError(
                f"batch {B} has no divisor >= the {S} pipeline stages; "
                "pass microbatches= explicitly or pad the batch")
        microbatches = min(divs, key=lambda m: (abs(m - 4 * S), m))
    stage_k = kernels.reshape((S, per) + tuple(kernels.shape[1:]))

    def stage_fn(ks, h):
        for k in ks:
            h = F.hex_conv2d(h, k, even_odd_offset=even_odd_offset,
                             radius=radius, padding=radius - 1)
            if activation is not None:
                h = activation(h)
        return h

    return pipeline_apply(stage_fn, stage_k, x, mesh,
                          microbatches=microbatches, axis_name=axis_name)
