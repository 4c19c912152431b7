"""What the window drives: the port, or the plain reference in its place.

A trainer's ``step(x, labels)`` is one training step on a rect batch (the
rect->hex resample, forward, loss, backward, AdamW) and returns the loss;
a server's ``request(x)`` returns the logits of a rect batch.  The port is
reached through its public entry points only (``hygrid_tpu_torch.models``:
the family's constructor, ``hexify_batch``, ``create_train_state``,
``train_step``).  :class:`RefTrainer` and :class:`RefServer` run the plain
reference (``perfbench/reference``), in float32 or, with a
:class:`~perfbench.reference.hexlib.Rounding`, in a lower precision: the
control.  The faults at the end break a program underneath the harness,
for the tests that show that ``correct`` comes out false.
"""
from __future__ import annotations

import importlib

import torch

from .reference import hexlib as H

B1 = 0.9  # AdamW's first-moment decay (optax's default, the port's too)


def reference_module(family):
    return importlib.import_module(f"perfbench.reference.{family.REFERENCE}")


class PortTrainer:
    """The port's training step on the family's model (built, with the
    run's weights loaded, by the harness)."""

    def __init__(self, model, cfg):
        from hygrid_tpu_torch.models import (create_train_state,
                                             hexify_batch, train_step)
        self._hexify, self._train_step = hexify_batch, train_step
        self.hex, self.interp = tuple(cfg["hex"]), cfg["interpolation"]
        self.model = model
        self.state = create_train_state(self.model)

    def step(self, x, labels):
        images = self._hexify(x, self.hex, self.interp)
        self.state, metrics = self._train_step(self.state, images, labels)
        return metrics["loss"]

    def first_grads(self) -> dict:
        """Each parameter's first gradient as the optimizer took it, from
        its first moment after one step (``m = (1 - b1) g``)."""
        opt = self.state.optimizer
        return {n: opt.state[p]["exp_avg"] / (1 - B1)
                for n, p in self.model.named_parameters()}

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.model.named_parameters()}


class PortServer:
    """The port's inference on the family's model (built, with the run's
    weights loaded, by the harness)."""

    def __init__(self, model, cfg):
        from hygrid_tpu_torch.models import hexify_batch
        self._hexify = hexify_batch
        self.hex, self.interp = tuple(cfg["hex"]), cfg["interpolation"]
        self.model = model.eval()

    @torch.inference_mode()
    def request(self, x):
        return self.model(self._hexify(x, self.hex, self.interp))


def load_weights(model, weights: dict) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


class _Plan:
    """The reference's rect->hex plan on a device."""

    def __init__(self, cfg, device):
        idx, wts = H.rect_to_hex_plan(*cfg["image"], *cfg["hex"])
        self.idx = torch.from_numpy(idx).to(device)
        self.wts = torch.from_numpy(wts).to(device)
        self.hex = tuple(cfg["hex"])

    def __call__(self, x, q=None):
        return H._store(q, H.apply_plan(x, self.idx, self.wts, self.hex))


class RefTrainer:
    """The plain reference's training step, over ``chunk`` images at a
    time (its gradients summed, so the step is the whole batch's)."""

    def __init__(self, family, cfg, weights: dict, q=None, chunk: int = 8):
        self.ref, self.cfg, self.q, self.chunk = (reference_module(family),
                                                  cfg, q, chunk)
        self.p = {k: v.detach().float().clone().requires_grad_()
                  for k, v in weights.items()}
        self.opt = H.AdamW(self.p)
        self.plan = _Plan(cfg, next(iter(weights.values())).device)

    def step(self, x, labels):
        with H.float32_exact():
            items = labels.numel()
            total = 0.0
            for i in range(0, x.shape[0], self.chunk):
                xs, ys = x[i:i + self.chunk], labels[i:i + self.chunk]
                logits = self.ref.forward(self.p, self.plan(xs.float(), self.q),
                                          self.cfg, self.q)
                loss = H.xent(logits, ys) / items
                loss.backward()
                total = total + loss.detach()
            grads = {k: v.grad for k, v in self.p.items()}
            self.opt.step(self.p, grads)
            for v in self.p.values():
                v.grad = None
        return total

    def first_grads(self) -> dict:
        return {k: m / (1 - B1) for k, m in self.opt.m.items()}

    def params(self) -> dict:
        return {k: v.detach() for k, v in self.p.items()}


class RefServer:
    """The plain reference's logits, ``chunk`` images at a time."""

    def __init__(self, family, cfg, weights: dict, q=None, chunk: int = 8):
        self.ref, self.cfg, self.q, self.chunk = (reference_module(family),
                                                  cfg, q, chunk)
        self.p = {k: v.detach().float().clone() for k, v in weights.items()}
        self.plan = _Plan(cfg, next(iter(weights.values())).device)

    @torch.no_grad()
    def request(self, x):
        with H.float32_exact():
            return torch.cat([
                self.ref.forward(self.p, self.plan(x[i:i + self.chunk].float(),
                                                   self.q), self.cfg, self.q)
                for i in range(0, x.shape[0], self.chunk)])


# ------------------------------------------------------------------ faults

class StateUnchanged:
    """A training step that computes and returns the loss but leaves the
    parameters and the optimizer as they were."""

    def __init__(self, trainer):
        self.t = trainer

    def step(self, x, labels):
        model = self.t.model.train()
        from hygrid_tpu_torch.models import dense_onehot_xent
        logits = model(self.t._hexify(x, self.t.hex, self.t.interp))
        if labels.ndim > 1:
            logits = logits.movedim(1, -1)
        return dense_onehot_xent(logits, labels).detach()

    def first_grads(self):
        return {n: torch.zeros_like(p) for n, p in self.t.params().items()}

    def params(self):
        return self.t.params()


class HalfBatch:
    """A training step on the first half of the batch alone (the mean taken
    over it); a request that serves the first half and leaves the rest 0."""

    def __init__(self, program):
        self.p = program

    def step(self, x, labels):
        half = x.shape[0] // 2
        return self.p.step(x[:half], labels[:half])

    def first_grads(self):
        return self.p.first_grads()

    def params(self):
        return self.p.params()

    def request(self, x):
        half = x.shape[0] // 2
        out = self.p.request(x[:half])
        return torch.cat([out, torch.zeros_like(out)])[:x.shape[0]]


class AlteredAnswer:
    """A request whose first image's logits come back with their classes
    rotated by one."""

    def __init__(self, server):
        self.p = server

    def request(self, x):
        out = self.p.request(x)
        return torch.cat([out[:1].roll(1, dims=1), out[1:]])


FAULTS = {"state_unchanged": StateUnchanged, "half_batch": HalfBatch,
          "altered_answer": AlteredAnswer}


def choose(which: str, cell, model, weights: dict, port, ref):
    """The program a run drives: ``"port"`` (``port(model, cfg)``),
    ``"control:<tf32|bf16|fp8>"`` (``ref`` in that precision, in the port's
    place) or ``"fault:<name>"`` (the port with a fault planted).  Raises
    ValueError for any other name."""
    kind, _, arg = which.partition(":")
    if kind == "control":
        return ref(cell.family, cell.cfg, weights, q=H.Rounding(arg))
    if kind == "port" and not arg:
        return port(model, cell.cfg)
    if kind == "fault" and arg in FAULTS:
        return FAULTS[arg](port(model, cell.cfg))
    raise ValueError(f"unknown program {which!r}")
