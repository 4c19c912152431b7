"""Tracing and timing helpers, PyTorch port of
``hygrid_tpu/utils/profiling.py``: named spans in ``torch.profiler``
traces, the port's call and launch counters, and wall times that wait for
the result's CUDA device to finish (``torch.cuda.synchronize``, in place of
``jax.block_until_ready``).

The port marks its layer boundaries with :func:`span` (``hygrid.*``
names) and counts each kernel wrapper's calls, each ``train_step`` and each
model forward with :func:`count`; :func:`counts` reads them all."""
from __future__ import annotations

import collections
import contextlib
import functools
import logging
import threading
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "annotate", "count", "counts", "CALLS", "device_timer",
           "Timer", "benchmark", "get_logger"]

_LOGGER = logging.getLogger("hygrid_tpu_torch")


def get_logger() -> logging.Logger:
    """The port's logger, ``"hygrid_tpu_torch"``."""
    return _LOGGER


_OFF = contextlib.nullcontext()


def span(name: str, ident=None):
    """A named range of the host's work, and of the device work it launches,
    in a ``torch.profiler`` trace; ``ident`` (an int) identifies the call it
    belongs to, and shows as the range's one input where the profiler
    records inputs (``record_shapes=True``).

    The range is an op-scope ``RecordFunction`` (``torch.profiler``'s own
    ``_RecordFunctionFast``), not ``record_function``'s user-scope one: the
    profiler links a kernel to the innermost op-scope range open when it
    was launched, so a kernel that a wrapper launches through ``ctypes``
    directly inside a span counts in the span's device time, where under a
    user-scope range it would land on the enclosing op or autograd node.

    Live only while a profiler runs: otherwise, at the cost of one attribute
    read, the one shared null context.  A profiler that records the device
    alone (no ``ProfilerActivity.CPU``) installs no observer of ranges, so a
    span leaves nothing in its trace either."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(
        name, () if ident is None else (ident,))


def annotate(name: Optional[str] = None) -> Callable:
    """Decorator: run a function inside :func:`span` so it shows up named in
    profiler traces."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)
        return wrapper
    return deco


CALLS = ("train_step", "forward", "hexify_batch", "residual", "hexresize",
         "conv_strided")
"""The counters of calls rather than of launches: the port's entry points,
and the stages a model counts on the card (the kernels they launch, where
the port has its own, count their launches as well); every other counter
counts a kernel wrapper's launches, under the kernel's name."""

_COUNTS: collections.Counter = collections.Counter()
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; returns its new total.  The kernel
    wrappers count each call (``"plan_gather"``, ``"hex_conv_layer"``, ...),
    the stages theirs on the card (``"residual"``, ``"hexresize"``,
    ``"conv_strided"``),
    :func:`~hygrid_tpu_torch.models.train_step` its steps and the models
    their forwards (:data:`CALLS`)."""
    with _COUNTS_LOCK:
        _COUNTS[name] += n
        return _COUNTS[name]


def counts() -> dict:
    """A snapshot of every counter since the process started; the calls
    made between two snapshots are their difference."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


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
