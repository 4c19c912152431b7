"""Reduce ``torch.profiler`` traces of the traced windows to what the
per-layer metrics read.

Two windows of the same calls are traced.  The first records the device
alone, so that the host runs at its own speed: its busy time is the union of
the intervals in which a kernel, copy or set ran (overlapping kernels count
once), over the window's length by the host's clock.  The second also
records the host's ops, which slows the host: it gives the device time of
the kernels launched under named host ops or autograd nodes, and what the
host was doing as the device went idle."""
from __future__ import annotations

import numpy as np

WINDOW_SPAN = "perfbench.window"


def _is_device(e) -> bool:
    return not str(e.device_type).endswith("CPU")


def _device_us(e) -> float:
    """Device time of the kernels a host event launched, its children's
    included."""
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else e.cuda_time_total)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals) -> float:
    """Length of the union of ``[(start, end)]``."""
    return sum(e - s for s, e in _merged(intervals))


def device_work(events, lo=-np.inf, hi=np.inf):
    """``[(start, end, name)]`` of the device's work within ``[lo, hi]``:
    kernels, copies and sets, not the intervals a host span leaves on the
    device's timeline."""
    spans = {e.name for e in events if not _is_device(e)}
    out = []
    for e in events:
        if (_is_device(e) and e.name not in spans
                and not getattr(e, "is_user_annotation", False)):
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if t > s:
                out.append((s, t, e.name))
    return out


class Busy:
    """The device-only window: ``busy_s`` of ``window_s``, and the device
    operations by summed time."""

    def __init__(self, events, window_s: float):
        self.work = device_work(events)
        self.window_s = window_s
        self.busy_s = union_us((s, t) for s, t, _ in self.work) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by_name: dict = {}
        for s, t, name in self.work:
            by_name[name] = by_name.get(name, 0.0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], us * 1e-6] for n, us in ops]


class Ops:
    """The window traced with the host's ops (its span ``WINDOW_SPAN``)."""

    def __init__(self, events):
        spans = [e for e in events if e.name == WINDOW_SPAN]
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} window spans")
        self.t0 = spans[0].time_range.start
        self.t1 = spans[0].time_range.end
        self.host = [e for e in events
                     if not _is_device(e) and e.name != WINDOW_SPAN]
        self.work = device_work(events, self.t0, self.t1)

    def op_device_s(self, names) -> float:
        """Device time of every kernel launched under a host op or autograd
        node of one of ``names`` (its own and its children's), in the
        window."""
        names = set(names)
        return sum(_device_us(e) for e in self.host if e.name in names
                   and self.t0 <= e.time_range.start <= self.t1) * 1e-6

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device by what the host was doing as each gap
        began (the innermost host op then running, on any thread), the
        largest ``top``."""
        busy = _merged((s, t) for s, t, _ in self.work)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:400]
        starts = np.array([e.time_range.start for e in self.host])
        ends = np.array([e.time_range.end for e in self.host])
        by_host: dict = {}
        for g0, g1 in gaps:
            inside = np.nonzero((starts <= g0) & (ends >= g0))[0]
            label = (self.host[inside[np.argmax(starts[inside])]].name
                     if inside.size else "no host op")
            by_host[label] = by_host.get(label, 0.0) + (g1 - g0)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], us * 1e-6] for n, us in idle]


class Trace:
    """Both traced windows."""

    def __init__(self, busy: Busy, ops: Ops):
        self.busy, self.ops = busy, ops
        self.busy_s, self.window_s = busy.busy_s, busy.window_s

    def op_device_s(self, names) -> float:
        return self.ops.op_device_s(names)

    def breakdown(self) -> dict:
        return {"device_ops": self.busy.device_ops(),
                "idle_gaps": self.ops.idle_gaps()}
