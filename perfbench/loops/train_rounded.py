"""Training steps in a reduced precision: :mod:`.train`'s inputs, steps,
set-up, window and numbers, and one number more, ``grad_rounded``.

In a deep network the first gradient of the leaves nearest the input moves
about as far under the mix's own rounding as under a coarser one (ReLU and
max-pool choices flip), so the worst leaf's gap (``grad``) does not tell a
lower precision from the mix's.  ``grad_rounded`` does: the median leaf's
gap as vectors (``|g - g_ref|`` over the larger of the leaf's reference
norm and the median leaf's), over the same median for the plain reference
computed in the mix's precision (:class:`~perfbench.reference.hexlib.
Rounding`: its products' operands, its stored activations and the
gradients entering its products rounded), both against the float32
reference, from the same weights on the same first batch.  A sound program
in the mix's precision reads about 1 at any size, a lower precision
several times that.  The mix's ``dtype`` is one of :data:`ROUNDING`."""
from __future__ import annotations

import statistics

from ..programs import RefTrainer
from ..reference import hexlib as H
from . import train
from .train import KIND, call, keeper, make_feed, program  # noqa: F401

ROUNDING = {"bfloat16": "bf16"}


class _Kept:
    """A trainer whose first gradient is kept, as vectors, when it is
    read."""

    def __init__(self, trainer):
        self.t, self.grads = trainer, None

    def step(self, x, labels):
        return self.t.step(x, labels)

    def first_grads(self) -> dict:
        grads = self.t.first_grads()
        self.grads = {n: g.detach().float().clone() for n, g in grads.items()}
        return grads

    def params(self) -> dict:
        return self.t.params()


def setup(program, feed, traffic: dict, weights: dict, device) -> dict:
    """:func:`.train.setup`, the first gradient kept."""
    kept = _Kept(program)
    out = train.setup(kept, feed, traffic, weights, device)
    return dict(out, grads=kept.grads)


def _first_grads(trainer, feed) -> dict:
    kept = _Kept(trainer)
    kept.step(*feed(0))
    kept.first_grads()
    return kept.grads


def _median_gap(got: dict, want: dict) -> float:
    norms = {n: float(g.norm()) for n, g in want.items()}
    floor = statistics.median(norms.values())
    return statistics.median(float((got[n] - g).norm()) / max(norms[n], floor)
                             for n, g in want.items())


def check(family, cfg, traffic, weights: dict, feed, readings: dict,
          keep: dict) -> dict:
    """:func:`.train.check`'s numbers, and ``grad_rounded``; the two medians
    it divides are ``grad_median`` and ``grad_median_rounded``."""
    out = train.check(family, cfg, traffic, weights, feed, readings, keep)
    want = _first_grads(RefTrainer(family, cfg, weights), feed)
    rounded = _first_grads(RefTrainer(
        family, cfg, weights, q=H.Rounding(ROUNDING[traffic["dtype"]])), feed)
    got, base = (_median_gap(readings["grads"], want),
                 _median_gap(rounded, want))
    item = dict(out["items"][0], grad_rounded=got / base)
    return dict(out, grad_rounded=got / base, items=[item], grad_median=got,
                grad_median_rounded=base)
