"""Median host milliseconds to enqueue one call of the run's loop: the
Python of the port's modules, kernel wrappers and autograd.  Read in the
traced run over its ``probe_calls``, each enqueued once the call before it
has completed, so that none waits for room in the launch queue."""
from perfbench.readers import host_enqueue_ms


def read(run):
    return host_enqueue_ms(run)
