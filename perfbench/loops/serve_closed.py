"""Closed-loop serving: each call is one request, a rect batch of the pool
resampled to hex and classified or segmented, with ``depth`` requests in
flight (the next is enqueued while the one before runs).

:func:`check` compares the logits the window served, for a sample of its
requests drawn from the seed (``sample`` among its first ``8 * sample``)
and its last ``pool``, with the plain reference's."""
from __future__ import annotations

import random

from . import synchronize
from .. import inputs
from ..programs import PortServer, RefServer, choose

KIND = "serve"


def make_feed(cell, seed: int, device):
    """``feed(i)``: the ``i % pool``-th batch of rect images (and no
    labels)."""
    xs, n = inputs.rect_images(cell, seed, device), cell.traffic["pool"]
    return lambda i: (xs[i % n], None)


def program(cell, model, weights: dict, device, which: str):
    return choose(which, cell, model, weights, PortServer, RefServer)


def call(program, feed):
    return lambda i: program.request(feed(i)[0])


def setup(program, feed, traffic: dict, weights: dict, device) -> dict:
    for i in range(traffic["warmup"]):
        program.request(feed(i)[0])
    synchronize(device)
    return {}


def keeper(seed: int, traffic: dict):
    """The window's first request is the one after the warm-up's."""
    return Keep(seed, traffic["sample"], traffic["pool"], traffic["warmup"])


class Keep:
    """The served outputs the check reads: those of ``sample`` requests
    drawn from the seed among the window's first ``8 * sample`` (the
    window's requests are numbered from ``first``), and of the last
    ``last`` requests.

    A sampled output is copied into a slot allocated at the window's first
    request, and the output itself released as any other: holding the
    sampled outputs at the seed's indices would change where the caching
    allocator places every later buffer, and with it the speed of the
    window's kernels, from seed to seed."""

    def __init__(self, seed: int, sample: int, last: int, first: int):
        self.order = sorted(random.Random(seed).sample(
            range(first, first + 8 * sample), sample))
        self.last, self.slots, self.seen, self.tail = last, None, [], []

    def __call__(self, i, out):
        if self.slots is None:
            self.slots = out.new_empty((len(self.order), *out.shape))
        if i in self.order:
            self.slots[self.order.index(i)].copy_(out)
            self.seen.append(i)
        self.tail = (self.tail + [(i, out)])[-self.last:]

    def outputs(self) -> dict:
        kept = {i: self.slots[self.order.index(i)] for i in self.seen}
        return {**kept, **dict(self.tail)}


def check(family, cfg, traffic, weights: dict, feed, readings: dict,
          keep: Keep) -> dict:
    """``logits``: the worst image's ``|served - reference| /
    |reference|`` over its logits, among the kept requests; ``items`` the
    same for each request."""
    ref = RefServer(family, cfg, weights)
    want, per = {}, {}
    for i, out in sorted(keep.outputs().items()):
        slot = i % traffic["pool"]
        if slot not in want:
            want[slot] = ref.request(feed(slot)[0]).float()
        r = want[slot].flatten(1)
        gap = (out.float().flatten(1) - r).norm(dim=1) / r.norm(dim=1)
        per[i] = float(gap.max())
    return dict(logits=max(per.values()),
                items=[{"request": i, "logits": v} for i, v in per.items()])
