"""Arithmetic the per-layer metrics' readers (``metrics/*.py``) share.
Each reads the run's own loop (a ``train`` or a ``serve`` call), and
returns None where the run has nothing for it to read: a run without a
trace, or one whose trace holds none of the ops it times."""
from __future__ import annotations

import statistics

from . import roofline


def step_mfu(run):
    """The model's operations a call (``roofline.model_flops``: a training
    step's or a forward's) times the window's calls, over the window's
    seconds and the dtype's peak, in percent."""
    flops = roofline.model_flops(run.layers,
                                 training=run.cell.loop.KIND == "train")
    rate = flops * run.window["calls"] / run.window["seconds"]
    return 100.0 * rate / roofline.PEAK_FLOPS[run.dtype]


def host_enqueue_ms(run):
    """The median host time of enqueuing one call, each enqueued once the
    call before it has completed (the traced run's ``probe_calls``), so
    that no enqueue waits for room in the launch queue."""
    if run.probe is None:
        return None
    return statistics.median(run.probe["enqueue_s"]) * 1e3


def device_idle_pct(run):
    """The share of the traced window in which no kernel, copy or set ran
    on the device."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run, parts, ops):
    """The summed bound of ``parts`` (one call's), times the traced
    window's calls, over the device time of the kernels launched under the
    host ops or autograd nodes ``ops``, in percent."""
    if run.trace is None or not parts:
        return None
    spent = run.trace.op_device_s(ops)
    if spent <= 0:
        return None
    calls = run.cell.traffic["trace_calls"]
    return 100.0 * roofline.summed_bound(parts)["bound_s"] * calls / spent
