"""Training utilities for hex models, PyTorch port of
``hygrid_tpu/models/train.py``: train state, train and eval steps, the
one-hot cross-entropy, mean IoU, the rect->hex input helper and the
synthetic datasets.

``hygrid_tpu``'s steps are pure functions of a flax ``TrainState``; here
the state holds a ``torch.nn.Module`` and a ``torch.optim.AdamW``, and
:func:`train_step` updates both in place.  Batch-norm statistics
(flax's ``batch_stats``) are the model's buffers: the optimizer never sees
them, :func:`train_step` runs the forward with ``train=True`` (batch
statistics, the running statistics updated) and :func:`eval_step` with
``train=False`` (the running statistics), as the reference's ``_forward``
does.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import geometry, sampling
from ..utils.profiling import count, span

__all__ = [
    "TrainState",
    "create_train_state",
    "train_step",
    "eval_step",
    "dense_onehot_xent",
    "hexify_batch",
    "synthetic_hex_cifar",
    "synthetic_hex_shapes",
    "mean_iou",
]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, sample_input=None,
                       tx: Optional[Callable] = None,
                       learning_rate: float = 1e-3) -> TrainState:
    """Wrap ``model`` with an optimizer over its parameters (its buffers,
such as BatchNorm's running statistics, are state the forward updates, as
``batch_stats`` beside optax's ``params``).

    ``tx`` is a callable ``params -> torch.optim.Optimizer``; the default is
    ``optax.adamw(learning_rate)``'s semantics in ``torch.optim.AdamW``:
    betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 on every parameter
    (optax's defaults; torch's own weight decay default is 1e-2).
    ``sample_input`` is accepted for ``hygrid_tpu``'s signature and not
    used: torch modules build their parameters at construction.
    """
    del sample_input
    params = list(model.parameters())
    if tx is None:
        optimizer = torch.optim.AdamW(params, lr=learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
    else:
        optimizer = tx(params)
    return TrainState(model=model, optimizer=optimizer)


def _class_axis_last(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Channel-first per-cell logits (B, K, h, w) against (B, h, w) labels
    move the class axis last, so one cross-entropy serves classifiers and
    segmenters."""
    if labels.ndim >= 2 and logits.ndim == labels.ndim + 1:
        return torch.movedim(logits, 1, -1)
    return logits


def dense_onehot_xent(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Mean softmax cross-entropy in the dense one-hot form, in the logits'
    dtype: the loss :func:`train_step` optimises (twin of
    ``hygrid_tpu.models.train.dense_onehot_xent``; a label outside
    ``[0, K)`` gets an all-zero row, as ``jax.nn.one_hot`` gives it).
    ``logits`` class-axis-last."""
    k = logits.shape[-1]
    onehot = (labels[..., None] == torch.arange(k, device=labels.device)
              ).to(logits.dtype)
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _forward(model: nn.Module, images: torch.Tensor, train: bool):
    """``model(images)``, with ``train=`` where its forward takes the flag
    (``hygrid_tpu``'s ``_forward`` passes it to ``apply``)."""
    if "train" in inspect.signature(model.forward).parameters:
        return model(images, train=train)
    return model(images)


def _global_mean(metrics: dict, group) -> dict:
    """The metrics' mean over ``group`` (each rank's are means over equal
    shards of the global batch): one all-reduce."""
    from ..parallel._comm import all_reduce_
    names = list(metrics)
    flat = all_reduce_(torch.stack([metrics[n].float() for n in names]),
                       group) / torch.distributed.get_world_size(group)
    return dict(zip(names, flat.unbind()))


def train_step(state: TrainState, images: torch.Tensor,
               labels: torch.Tensor, *, mesh=None):
    """One optimisation step: forward, :func:`dense_onehot_xent`, backward,
    optimizer update.  Unlike ``hygrid_tpu``'s pure step it updates
    ``state`` (the model's parameters, the optimizer's moments and
    ``state.step``) in place, and returns it with ``{"loss", "accuracy"}``
    as 0-d tensors.  The parameters' ``.grad`` keep this step's grads.  The
    forward runs with ``train=True`` where the model takes the flag, so
    BatchNorm normalises with batch statistics and updates its running
    statistics.

    ``labels`` may be (B,) class ids or (B, h, w) per-cell ids against
    (B, K, h, w) logits.

    With a ``mesh`` (:mod:`hygrid_tpu_torch.parallel`), ``images`` and
    ``labels`` are this rank's equal shard of the global batch over its
    ``"dp"`` axis: BatchNorm sums its statistics over that group
    (``nn.modules.batch_stats_group``), the grads are averaged over it
    (one all-reduce a dtype) before the update, and the metrics are the
    global batch's.  A step then equals one step on the global batch, as
    ``jit`` over a sharded batch gives in ``hygrid_tpu``.

    Each step is counted as ``"train_step"`` (``utils.profiling.counts``)
    and, under a profiler, traced as the span ``hygrid.train_step``
    identified by ``state.step``.
    """
    from ..nn.modules import batch_stats_group
    count("train_step")
    group = None if mesh is None else mesh.group("dp")
    with span("hygrid.train_step", state.step):
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with batch_stats_group(group):
            logits = _class_axis_last(_forward(model, images, True), labels)
        loss = dense_onehot_xent(logits, labels)
        loss.backward()
        metrics = {"loss": loss.detach(),
                   "accuracy": _accuracy(logits.detach(), labels)}
        if group is not None:
            from ..parallel._comm import average_grads_
            average_grads_(model.parameters(), group)
            metrics = _global_mean(metrics, group)
        state.optimizer.step()
    state.step += 1
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, images: torch.Tensor,
              labels: torch.Tensor, *, mesh=None) -> dict:
    """Integer-label cross-entropy and accuracy, without a grad, on the
    running statistics (``train=False``); with a ``mesh``, of this rank's
    shard, averaged over the ``"dp"`` group."""
    logits = _class_axis_last(_forward(state.model.eval(), images, False),
                              labels)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[..., None].long()).squeeze(-1).mean()
    metrics = {"loss": loss, "accuracy": _accuracy(logits, labels)}
    if mesh is not None:
        metrics = _global_mean(metrics, mesh.group("dp"))
    return metrics


def mean_iou(logits: torch.Tensor, labels: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """Mean intersection-over-union over the classes present in the
    prediction or the truth.  ``logits`` (B, K, h, w) or (B, h, w, K);
    ``labels`` (B, h, w)."""
    pred = _class_axis_last(logits, labels).argmax(-1)
    ious, valid = [], []
    for k in range(num_classes):
        p, t = pred == k, labels == k
        inter, union = (p & t).sum(), (p | t).sum()
        ious.append(torch.where(union > 0, inter / union.clamp(min=1), 0.0))
        valid.append(union > 0)
    ious, valid = torch.stack(ious), torch.stack(valid)
    return (ious * valid).sum() / valid.sum().clamp(min=1)


def hexify_batch(images: torch.Tensor,
                 hex_size: Optional[Tuple[int, int]] = None,
                 interpolation: str = "bilinear", *,
                 plain: bool = False) -> torch.Tensor:
    """rect (B, C, H, W) -> hex (B, C, h, w) through one resample plan.

    Default target is (H//2, W//2).  A CUDA batch runs the resample kernel
    that ``apply_plan_auto`` picks for the plan; ``plain=True`` runs the
    plain gather-blend on any device.  Each call is counted as
    ``"hexify_batch"`` and traced as the span ``hygrid.hexify``.
    """
    h, w = images.shape[-2:]
    if hex_size is None:
        hex_size = (h // 2, w // 2)
    with span("hygrid.hexify", count("hexify_batch")):
        if not plain:
            return geometry.rect_to_hex_resample(images, hex_size,
                                                 interpolation)
        plan = geometry.rect_to_hex_plan(h, w, *hex_size, interpolation)
        return sampling.apply_plan(images, plan)


def synthetic_hex_cifar(rng: np.random.Generator, n: int, *,
                        num_classes: int = 10, size: int = 32,
                        device="cuda"):
    """Deterministic CIFAR-like synthetic data (class-dependent oriented
    gratings + noise), hexified to (size//2, size//2): the numpy draws of
    ``hygrid_tpu.models.synthetic_hex_cifar``, so one seed gives both
    packages the same data.  Returns float32 images and int64 labels on
    ``device``, where the images are hexified (the card unless the caller
    asks for the CPU)."""
    labels = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:size, 0:size] / size
    images = np.zeros((n, 3, size, size), np.float32)
    for k in range(num_classes):
        sel = labels == k
        angle = np.pi * k / num_classes
        wave = np.sin(2 * np.pi * (np.cos(angle) * xx + np.sin(angle) * yy)
                      * (2 + k % 3))
        images[sel] = wave[None]
    images += rng.normal(0, 0.3, images.shape).astype(np.float32)
    return (hexify_batch(torch.from_numpy(images).to(device)),
            torch.from_numpy(labels).to(device))


def synthetic_hex_shapes(rng: np.random.Generator, n: int, *, size: int = 64,
                         num_classes: int = 4, noise: float = 0.25):
    """Synthetic dense-prediction task: rect scenes of noisy coloured disks,
    squares and diamonds -> per-cell class labels, both hexified (images
    bilinear, labels through the exact nearest plan).  The numpy draws of
    ``hygrid_tpu.models.synthetic_hex_shapes``.  Returns float32 images
    (n, 3, size//2, size//2) and int32 labels (n, size//2, size//2)."""
    colors = np.array([[0.1, 0.1, 0.1],          # background
                       [0.9, 0.3, 0.2],          # disk
                       [0.2, 0.8, 0.3],          # square
                       [0.3, 0.4, 0.9]])[:num_classes]
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.zeros((n, 3, size, size), np.float32)
    labels = np.zeros((n, size, size), np.int64)
    for i in range(n):
        images[i] = colors[0][:, None, None]
        for _ in range(int(rng.integers(2, 5))):
            cls = int(rng.integers(1, num_classes))
            cy, cx = rng.integers(10, size - 10, 2)
            r = int(rng.integers(6, 12))
            if cls == 1:
                mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            elif cls == 2:
                mask = (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
            else:
                mask = np.abs(yy - cy) + np.abs(xx - cx) <= r
            images[i, :, mask] = colors[cls]
            labels[i][mask] = cls
    images += rng.normal(0, noise, images.shape).astype(np.float32)
    hex_images = hexify_batch(torch.from_numpy(images))
    hex_labels = geometry.rect_to_hex_resample(
        torch.from_numpy(labels.astype(np.int32)), (size // 2, size // 2),
        "nearest")
    return hex_images, hex_labels
