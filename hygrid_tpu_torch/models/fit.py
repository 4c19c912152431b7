"""High-level training loop (``fit``), PyTorch port of
``hygrid_tpu/models/fit.py`` on one device.  Its ``mesh`` (data parallel)
and ``checkpoint_path`` options wait for the port's ``parallel/`` and
``utils/`` (ROADMAP queue 1 items 19-20) and raise."""
from __future__ import annotations

import logging
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .train import TrainState, create_train_state, eval_step, train_step

__all__ = ["fit"]

logger = logging.getLogger("hygrid_tpu_torch")


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
        state: resume from an existing :class:`TrainState` instead of
            creating one with ``tx`` / ``learning_rate``.

    Returns ``(final_state, history)``; history maps ``loss``,
    ``accuracy``, ``eval_loss`` and ``eval_accuracy`` to lists: one entry
    per ``log_every`` steps, plus each epoch's last step when it falls
    between them, and one eval entry per epoch.
    """
    for name, value in (("mesh", mesh), ("checkpoint_path", checkpoint_path)):
        if value is not None:
            raise NotImplementedError(
                f"fit: {name} is not ported yet (ROADMAP queue 1 items "
                "19-20: parallel/ on torch.distributed, utils/ checkpoints)")
    if state is None:
        state = create_train_state(model, tx=tx, learning_rate=learning_rate)
    device = next(state.model.parameters()).device

    def on_device(images, labels):
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
            state, metrics = train_step(state, *on_device(images, labels))
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
            agg = [eval_step(state, *on_device(images, labels))
                   for images, labels in eval_data]
            el = float(np.mean([float(m["loss"]) for m in agg]))
            ea = float(np.mean([float(m["accuracy"]) for m in agg]))
            history["eval_loss"].append(el)
            history["eval_accuracy"].append(ea)
            logger.info("epoch %d eval loss %.4f acc %.3f", epoch, el, ea)
    return state, history
