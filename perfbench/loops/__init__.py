"""The loops a traffic mix names (``"loop"`` in ``perfbench/traffic``):
each module gives ``KIND``, ``make_feed`` (the run's inputs from the seed),
``program`` (what the window drives: the port, the control or a fault),
``setup``, ``call``, ``keeper`` (what the window keeps for the check) and
``check`` (the numbers compared, and ``items``, the same for each item
compared); the window around the call is :func:`run_window`'s, the same
for every loop.  A mix that needs other inputs or another entry of the
port is a new loop module beside these."""
from __future__ import annotations

import collections
import contextlib
import time

import torch


class _HostEvent:
    """A completion event for a device that runs each call to its end."""

    def record(self):
        pass

    def synchronize(self):
        pass


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span(name, traced):
    return (torch.profiler.record_function(name) if traced
            else contextlib.nullcontext())


def run_window(call, first: int, device, depth: int, *, seconds=None,
               calls=None, keep=None, traced=False) -> dict:
    """Enqueue ``call(first)``, ``call(first + 1)``, ... for ``seconds`` by
    the host's clock, or ``calls`` times, with at most ``depth`` calls in
    flight: before a call is enqueued the oldest in flight is waited for
    when ``depth`` are.  Each call's enqueue time is taken around the call
    alone, and its latency from the start of its enqueue to the moment its
    completion event is seen.  The window runs from a synchronised start to
    the completion of its last call.  ``keep(i, out)`` sees each call's
    result as it completes."""
    cuda = torch.device(device).type == "cuda"
    inflight = collections.deque()
    enqueue, latency = [], []

    def retire():
        t_a, ev, out, i = inflight.popleft()
        with _span("perfbench.wait", traced):
            ev.synchronize()
        latency.append(time.perf_counter() - t_a)
        if keep is not None:
            keep(i, out)

    synchronize(device)
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    n = 0
    while (n < calls) if deadline is None else (time.perf_counter() < deadline):
        if len(inflight) >= depth:
            retire()
        t_a = time.perf_counter()
        with _span("perfbench.call", traced):
            out = call(first + n)
        ev = torch.cuda.Event() if cuda else _HostEvent()
        ev.record()
        enqueue.append(time.perf_counter() - t_a)
        inflight.append((t_a, ev, out, first + n))
        n += 1
    while inflight:
        retire()
    return dict(calls=n, seconds=time.perf_counter() - t0, enqueue_s=enqueue,
                latency_s=latency, first=first)
