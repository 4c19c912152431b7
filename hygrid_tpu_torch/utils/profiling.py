"""Tracing and timing helpers, PyTorch port of
``hygrid_tpu/utils/profiling.py``: named ranges in ``torch.profiler``
traces, and wall times that wait for the result's CUDA device to finish
(``torch.cuda.synchronize``, in place of ``jax.block_until_ready``)."""
from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Callable, Optional

import torch

__all__ = ["annotate", "device_timer", "Timer", "benchmark", "get_logger"]

_LOGGER = logging.getLogger("hygrid_tpu_torch")


def get_logger() -> logging.Logger:
    """The port's logger, ``"hygrid_tpu_torch"``."""
    return _LOGGER


def annotate(name: Optional[str] = None) -> Callable:
    """Decorator: run a function inside ``torch.profiler.record_function``
    so it shows up named in profiler traces."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _synchronize(result) -> None:
    """Wait for every CUDA device that a tensor of ``result`` (a tensor or
    a list, tuple or dict of them) lives on."""
    devices = set()

    def visit(r):
        if torch.is_tensor(r):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, dict):
            for v in r.values():
                visit(v)
        elif isinstance(r, (list, tuple)):
            for v in r:
                visit(v)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(label: str = "", logger: Optional[logging.Logger] = None):
    """Context manager timing until the device has finished the result
    placed in ``timer.result``::

        with device_timer("resample") as t:
            t.result = hexresize(img, (512, 512))
    """
    t = Timer(label)
    t0 = time.perf_counter()
    yield t
    if t.result is not None:
        _synchronize(t.result)
    t.elapsed = time.perf_counter() - t0
    (logger or _LOGGER).debug("%s: %.3f ms", label, t.elapsed * 1e3)


class Timer:
    def __init__(self, label: str = ""):
        self.label = label
        self.result = None
        self.elapsed: float = float("nan")


def benchmark(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean wall ms of ``fn(*args)`` over ``iters`` calls after ``warmup``,
    waiting for the result's device before and after."""
    for _ in range(warmup):
        _synchronize(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    _synchronize(out)
    return (time.perf_counter() - t0) / iters * 1e3
