"""Run one cell of the benchmark (``BENCHMARK.json`` at the repository
root) and print its result line, the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The kernels' library is built at the first run of a checkout into its
``build/hygrid_tpu_torch/``; the caches PyTorch and CUDA keep are pointed
at fixed directories under ``build/perfbench/``, so only that run builds.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CACHE / sub)
    (CACHE / sub).mkdir(parents=True, exist_ok=True)
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
