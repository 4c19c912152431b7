"""Percent of the traced window of the run's calls in which the device ran
nothing (100 minus the union of its kernel, copy and set intervals)."""
from perfbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
