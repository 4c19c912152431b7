"""Read the numbers a cell's ``correct`` compares, for the limits in
``cells/<cell>.json``: the port's on many seeds (the lower readings), the
control's (the plain reference in the precision below the configuration's,
in the port's place) and the planted faults' (the upper readings).  One
JSON line a run, on standard output; every run in one process:

    python3 perfbench/calibrate.py --workload <cell> --seconds 2 \\
        --runs port:1-12 control:bf16:101-103 fault:half_batch:201-203

``--set key=value`` (a JSON value) replaces an entry of the cell's traffic
mix or configuration for every run of the call, to read the numbers at
another batch or label layout before a mix is written.

Training cells compare the set-up's first steps, so their window can be
short; a serving cell's window should be long enough to serve the sampled
requests.
"""
import time

T_START = time.perf_counter()

import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def _runs(specs):
    for spec in specs:
        program, _, seeds = spec.rpartition(":")
        lo, _, hi = seeds.partition("-")
        for seed in range(int(lo), int(hi or lo) + 1):
            yield program, seed


def main(argv) -> int:
    import argparse
    import torch
    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="program:first-last, program one of port, "
                         "control:<tf32|bf16|fp8>, fault:<name>")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="replace an entry of the mix or configuration")
    args = ap.parse_args(argv)
    overrides = {k: json.loads(v) for k, _, v in
                 (item.partition("=") for item in args.set)}
    for program, seed in _runs(args.runs):
        t0, numbers, stages = time.perf_counter(), {}, []
        out = harness.run(args.workload, seed, args.seconds, False,
                          root=ROOT, t_start=t0, program=program,
                          overrides=overrides, log=stages.append,
                          details=numbers)
        print(json.dumps({"workload": args.workload, "program": program,
                          "seed": seed, "set": overrides,
                          "correct": out["correct"],
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "stages": stages,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
