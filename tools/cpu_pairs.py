#!/usr/bin/env python3
"""Compare two checkouts' CPU resampling in fresh processes, in turn.

    python3 tools/cpu_pairs.py ROOT_A ROOT_B [PAIRS]

Each process imports ``hygrid_tpu_torch`` from one checkout (``ROOT_A``,
for example a ``git archive`` of the parent, or ``ROOT_B``, this one),
runs on the CPU with 4 threads, and times by
``hygrid_tpu_torch.utils.profiling.benchmark`` (mean wall ms over 5 calls
after 1 warm-up, 3 timings, their median kept), on float32 data from a
numpy seed:

* ``hexify_batch``: ``models.hexify_batch`` of a (8, 3, 256, 256) batch,
  the rect->hex plan cached as users meet it;
* ``tiled rect_to_hex`` and ``tiled hexresize``: ``ops.tiled`` on a
  (1, 2048, 2048) raster to 1024^2 in 256-row tiles, each tile's sub-plan
  built per call.

``PAIRS`` (default 3) pairs of processes run A, B then B, A, alternately.
Prints one JSON line a process, then per workload each side's
per-process medians.  An exploratory tool; no check runs it.  It imports
no JAX.
"""
import json
import statistics
import subprocess
import sys

CHILD = r'''
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(4)
from hygrid_tpu_torch import models
from hygrid_tpu_torch.ops import tiled
from hygrid_tpu_torch.utils.profiling import benchmark

rng = np.random.default_rng(0)
batch = torch.from_numpy(rng.random((8, 3, 256, 256), np.float32))
raster = rng.random((1, 2048, 2048), np.float32)
work = {
    "hexify_batch": lambda: models.hexify_batch(batch),
    "tiled rect_to_hex": lambda: tiled.tiled_rect_to_hex(
        raster, (1024, 1024), tile_rows=256, device="cpu"),
    "tiled hexresize": lambda: tiled.tiled_hexresize(
        raster, (1024, 1024), tile_rows=256, device="cpu"),
}
print(json.dumps({name: statistics.median(
    benchmark(fn, iters=5, warmup=1) for _ in range(3))
    for name, fn in work.items()}))
'''


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, root], check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    a, b = sys.argv[1], sys.argv[2]
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    got = {a: [], b: []}
    for i in range(pairs):
        for root in ((a, b) if i % 2 == 0 else (b, a)):
            got[root].append(run(root))
            print(json.dumps({"root": root, **got[root][-1]}), flush=True)
    for name in got[a][0]:
        print(json.dumps({"workload": name, "unit": "ms", **{
            side: statistics.median(r[name] for r in got[root])
            for side, root in (("A", a), ("B", b))}}))


if __name__ == "__main__":
    main()
