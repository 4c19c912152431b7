"""The whole call's operations a second (hex convs, transposed convs, the
head; a training step's or a forward's, by the run's loop), as a share of
the dtype's published peak (float32 67, bfloat16 989 TFLOP/s)."""
from perfbench.readers import step_mfu


def read(run):
    return step_mfu(run)
