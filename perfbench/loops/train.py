"""Training steps dispatched back to back: each call is one step (the
rect->hex resample of a batch, forward, loss, backward, AdamW) on the next
batch of the pool, with no read of the loss on the host.

The set-up drives the same step object through its first steps on rows
that all differ; its first gradient (from the optimizer's first moment
after one step), its losses and its parameters' change after
``checked_steps`` are what :func:`check` holds against the plain
reference, which follows the same steps from the same weights."""
from __future__ import annotations

import statistics

import torch

from . import synchronize
from .. import inputs
from ..programs import PortTrainer, RefTrainer, choose

KIND = "train"


def make_feed(cell, seed: int, device):
    """``feed(i)``: the ``i % pool``-th batch of rect images and its labels,
    uniform over the classes: a class an image or, for a segmenter, a
    class a block of ``label_block`` x ``label_block`` hex cells."""
    t, cfg = cell.traffic, cell.cfg
    xs = inputs.rect_images(cell, seed, device)
    n, b, k = t["pool"], t["batch"], cfg["num_classes"]
    gen = inputs.generator(seed, 2, device)
    if cell.family.TASK == "classify":
        labels = torch.randint(0, k, (n, b), generator=gen, device=device)
    else:
        blk = t["label_block"]
        h, w = cfg["hex"]
        coarse = torch.randint(0, k, (n, b, -(-h // blk), -(-w // blk)),
                               generator=gen, device=device)
        labels = coarse.repeat_interleave(blk, 2).repeat_interleave(
            blk, 3)[:, :, :h, :w].contiguous()
    return lambda i: (xs[i % n], labels[i % n])


def program(cell, model, weights: dict, device, which: str):
    return choose(which, cell, model, weights, PortTrainer, RefTrainer)


def call(program, feed):
    return lambda i: program.step(*feed(i))


def _readings(program, feed, steps: int, checked: int, w0: dict):
    losses, grad, update = [], None, None
    for i in range(steps):
        losses.append(program.step(*feed(i)))
        if i == 0:
            grad = {n: g.norm() for n, g in program.first_grads().items()}
        if i == checked - 1:
            update = {n: (p - w0[n]).norm()
                      for n, p in program.params().items()}
    return dict(loss=[float(v) for v in losses[:checked]],
                grad={n: float(v) for n, v in grad.items()},
                update={n: float(v) for n, v in update.items()})


def keeper(seed: int, traffic: dict):
    """Training compares the set-up's steps: the window keeps nothing."""
    return None


def setup(program, feed, traffic: dict, weights: dict, device) -> dict:
    """Warm-up: ``warmup`` steps, the first ``checked_steps`` of them
    read."""
    w0 = {n: v.clone() for n, v in weights.items()}
    out = _readings(program, feed, traffic["warmup"],
                    traffic["checked_steps"], w0)
    synchronize(device)
    return out


def _leaf_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    floor = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], floor) for n in names}


def check(family, cfg, traffic, weights: dict, feed, readings: dict,
          keep: dict) -> dict:
    """The numbers compared: ``loss``, the worst relative gap of the checked
    steps' losses; ``loss1``, the first step's alone (the forward from the
    same weights, which the later steps' drift does not reach); ``grad``,
    of the first gradient's leaf norms; ``update``, of the parameters'
    change after the checked steps, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a smaller one
    moves by round-off alone)."""
    n = traffic["checked_steps"]
    ref = _readings(RefTrainer(family, cfg, weights), feed, n, n, weights)
    names = list(ref["grad"])
    floor = statistics.median(ref["grad"].values())
    moved = [k for k in names if ref["grad"][k] >= 1e-3 * floor]
    by_step = [abs(a - b) / abs(b) for a, b in zip(readings["loss"],
                                                    ref["loss"])]
    grad = _leaf_gaps(readings["grad"], ref["grad"], names)
    update = _leaf_gaps(readings["update"], ref["update"], moved)
    out = dict(loss=max(by_step), loss1=by_step[0], grad=max(grad.values()),
               update=max(update.values()))
    return dict(out, items=[out], loss_by_step=by_step, grad_by_leaf=grad,
                update_by_leaf=update)
