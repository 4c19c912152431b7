"""Small sizes at which the CPU tests run a cell end to end: the
configuration's widths, a 32 x 32 image (16 x 16 hex cells), batches of
4."""
from pathlib import Path
import time

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"batch": 4, "image": [32, 32], "hex": [16, 16], "pool": 3,
         "warmup": 3, "trace_calls": 3, "label_block": 4, "sample": 2}


def run(cell: str, program: str = "port", seed: int = 2 ** 31 + 7,
        trace: bool = False, root: Path = ROOT, **kw) -> dict:
    from perfbench import harness
    return harness.run(cell, seed, 0.3, trace, root=root,
                       t_start=time.perf_counter(), device="cpu",
                       program=program, overrides={**SIZES, **kw},
                       log=lambda msg: None)
