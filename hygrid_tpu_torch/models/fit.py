"""High-level training loop (``fit``), PyTorch port of
``hygrid_tpu/models/fit.py``: steps on the device of the model's
parameters, optional data parallelism over a mesh's ``"dp"`` ranks,
metric aggregation, periodic eval and per-epoch checkpoints."""
from __future__ import annotations

import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .train import TrainState, create_train_state, eval_step, train_step
from ..utils.profiling import get_logger

__all__ = ["fit"]


def fit(model, train_data: Iterable[Tuple], *, num_epochs: int = 1,
        eval_data: Optional[Iterable[Tuple]] = None, tx=None,
        learning_rate: float = 1e-3, mesh=None,
        state: Optional[TrainState] = None,
        checkpoint_path: Optional[str] = None,
        log_every: int = 50) -> Tuple[TrainState, dict]:
    """Train ``model`` over (images, labels) batches on the device of its
    parameters.

    Args:
        train_data: iterable (re-iterable per epoch) of (images, labels);
            images (B, C, H, W) hex storage, numpy arrays or tensors.
        mesh: a :class:`hygrid_tpu_torch.parallel.Mesh` with a ``"dp"``
            axis: rank 0's parameters and buffers are broadcast to every
            rank, each rank trains on its ``shard_batch`` slice of every
            (global) batch, and each step averages the grads over ``dp``
            (:func:`train_step` with ``mesh``).
        state: resume from an existing :class:`TrainState` instead of
            creating one with ``tx`` / ``learning_rate``.
        checkpoint_path: after each epoch the parameters go to
            ``f"{checkpoint_path}_e{epoch}.npz"`` (on rank 0 alone under a
            mesh).

    Returns ``(final_state, history)``; history maps ``loss``,
    ``accuracy``, ``eval_loss`` and ``eval_accuracy`` to lists: one entry
    per ``log_every`` steps, plus each epoch's last step when it falls
    between them, and one eval entry per epoch.  Under a mesh the metrics
    are the global batch's.
    """
    logger = get_logger()
    if state is None:
        state = create_train_state(model, tx=tx, learning_rate=learning_rate)
    device = next(state.model.parameters()).device
    writer = True
    if mesh is not None:
        from ..parallel import replicate, shard_batch
        replicate(state.model, mesh)
        writer = int(mesh.ranks.flat[0]) == torch.distributed.get_rank()

    def on_device(images, labels):
        if mesh is not None:
            return (shard_batch(images, mesh, device=device),
                    shard_batch(labels, mesh, device=device))
        return (torch.as_tensor(images, device=device),
                torch.as_tensor(labels, device=device))

    history: dict = {"loss": [], "accuracy": [], "eval_loss": [],
                     "eval_accuracy": []}
    global_step = 0
    metrics = None
    t0 = time.perf_counter()
    for epoch in range(num_epochs):
        steps_this_epoch = 0
        for images, labels in train_data:
            state, metrics = train_step(state, *on_device(images, labels),
                                        mesh=mesh)
            global_step += 1
            steps_this_epoch += 1
            if global_step % log_every == 0:
                loss = float(metrics["loss"])
                acc = float(metrics["accuracy"])
                history["loss"].append(loss)
                history["accuracy"].append(acc)
                logger.info("step %d epoch %d loss %.4f acc %.3f (%.1f s)",
                            global_step, epoch, loss, acc,
                            time.perf_counter() - t0)
        if steps_this_epoch and global_step % log_every != 0:
            # record the epoch's last step, so that runs shorter than
            # log_every still have a history
            history["loss"].append(float(metrics["loss"]))
            history["accuracy"].append(float(metrics["accuracy"]))
        if not steps_this_epoch and epoch > 0:
            logger.warning(
                "epoch %d yielded no batches: train_data must be "
                "re-iterable for multi-epoch fit()", epoch)
        if eval_data is not None:
            agg = [eval_step(state, *on_device(images, labels), mesh=mesh)
                   for images, labels in eval_data]
            el = float(np.mean([float(m["loss"]) for m in agg]))
            ea = float(np.mean([float(m["accuracy"]) for m in agg]))
            history["eval_loss"].append(el)
            history["eval_accuracy"].append(ea)
            logger.info("epoch %d eval loss %.4f acc %.3f", epoch, el, ea)
        if checkpoint_path is not None and writer:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(f"{checkpoint_path}_e{epoch}.npz",
                            dict(state.model.named_parameters()))
    return state, history
