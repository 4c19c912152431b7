"""The 95th percentile (nearest rank) of the latency of every request of
the window, from the moment the host began to enqueue it to the moment its
completion event was seen."""
import math


def read(run):
    if run.cell.loop.KIND != "serve":
        return None
    lat = sorted(run.window["latency_s"])
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
