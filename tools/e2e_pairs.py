#!/usr/bin/env python3
"""Compare two checkouts end to end in fresh processes, in turn, on one
NVIDIA GPU.

    python3 tools/e2e_pairs.py ROOT_A ROOT_B [PAIRS]

Each process imports ``hygrid_tpu_torch`` from one checkout (``ROOT_A``,
for example a ``git archive`` of the parent, or ``ROOT_B``, this one),
builds HexCNN-small and HexUNet-small (GN, bf16, random weights from a
seed) as users do, and times by CUDA events, 3 timings each after 2
warm-up calls: a HexCNN-small request (b=32 512^2, rect->hex included, 20
calls a timing) and AdamW training step (10), the same step of
HexCNN-small in its default dtype, float32 (``train_hexcnn_f32``, 5), the
request's host time
(``serve_hexcnn host``: ``chip_smoke.host_ms``, 10 requests enqueued back
to back, 3 timings), a HexUNet-small request (b=8, 20) and training step (5), and the pipelines of ``chip_smoke.py``
phase 13 (P-512, P-512 fused, P-4K; 5 calls), each pipeline also on the
device alone (one call replayed in a CUDA graph, ``<name> graph``) and
with ``chip_smoke._pipeline_diag`` (its kernels' device ms a call, the
allocator's cudaMalloc/cudaFree calls while timed).  It also reads from
torch.profiler the device ms a HexCNN-small request spends in
``hex_conv_kernel`` and in ``plan_gather_kernel``.  ``PAIRS`` (default 10) pairs of processes run
A, B then B, A, alternately, so that drift in the host's speed falls on
both sides alike.

Prints one JSON line a process, then per workload each side's per-process
medians and the number of pairs in which B was faster.  An exploratory
tool; no check runs it.  It imports no JAX.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import functools, importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
# this tool's chip_smoke.py (build_pipeline, graph_ms), whatever the
# checkout under test holds
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from hygrid_tpu_torch.models import (HexUNet, create_train_state,
                                     hexcnn_small, hexify_batch, train_step)
assert sys.modules["hygrid_tpu_torch"].__file__.startswith(sys.argv[1])
assert "jax" not in sys.modules
bf = torch.bfloat16
gen = torch.Generator(device="cuda").manual_seed(21)
unet_kw = dict(num_classes=4, widths=(32, 64, 128), norm="GN")
x_cnn = torch.rand((32, 3, 512, 512), generator=gen, device="cuda")
x_unet = torch.rand((8, 3, 512, 512), generator=gen, device="cuda")
cnn_labels = torch.arange(32, device="cuda") % 10
unet_labels = torch.randint(0, 4, (8, 256, 256), generator=gen,
                            device="cuda")
cnn_state = create_train_state(hexcnn_small(norm="GN", dtype=bf,
                                            device="cuda", generator=gen))
cnn32_state = create_train_state(hexcnn_small(norm="GN", device="cuda",
                                              generator=gen))
unet_state = create_train_state(HexUNet(dtype=bf, generator=gen, **unet_kw))
serve_cnn = hexcnn_small(norm="GN", dtype=bf, device="cuda",
                         generator=gen).eval()
serve_unet = HexUNet(dtype=bf, generator=gen, **unet_kw).eval()
runs = {
    "serve_hexcnn": (True, 20, lambda: serve_cnn(hexify_batch(x_cnn.to(bf)))),
    "train_hexcnn": (False, 10, lambda: train_step(
        cnn_state, hexify_batch(x_cnn), cnn_labels)),
    "train_hexcnn_f32": (False, 5, lambda: train_step(
        cnn32_state, hexify_batch(x_cnn), cnn_labels)),
    "serve_hexunet": (True, 20,
                      lambda: serve_unet(hexify_batch(x_unet.to(bf)))),
    "train_hexunet": (False, 5, lambda: train_step(
        unet_state, hexify_batch(x_unet), unet_labels)),
}


def timed(fn, calls):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / calls)
    return ms


res, diag = {}, {}
for name, (serving, calls, fn) in runs.items():
    with torch.inference_mode(serving):
        res[name] = timed(fn, calls)
with torch.inference_mode():
    # the host's time a request: 10 requests enqueued back to back
    res["serve_hexcnn host"] = [smoke.host_ms(
        torch, runs["serve_hexcnn"][2], calls=10) for _ in range(3)]
for name, batch, shape, fused in smoke.PIPELINES:
    pipe, _ = smoke.build_pipeline(shape, smoke.PIPE_CHANNELS,
                                   smoke.PIPE_LAYERS, smoke.PIPE_RADIUS, bf,
                                   fused=fused)
    x = torch.rand((batch, 3) + shape, generator=gen, device="cuda")
    with torch.inference_mode():
        res[name] = timed(functools.partial(pipe, x), 5)
        res[f"{name} graph"] = [smoke.graph_ms(
            torch, functools.partial(pipe, x), iters=5) for _ in range(3)]
        diag[name] = smoke._pipeline_diag(torch, functools.partial(pipe, x))
with torch.inference_mode():
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            runs["serve_hexcnn"][2]()
        torch.cuda.synchronize()
kernels = {"hex_conv_kernel": 0.0, "plan_gather_kernel": 0.0}
for e in prof.key_averages():
    for k in kernels:
        if k in e.key:
            kernels[k] += getattr(e, "device_time_total", 0) / 5 / 1e3
print("RESULT", json.dumps({"ms": res, "serve_hexcnn_kernel_ms": kernels,
                            "pipeline_diag": diag,
                            "device": torch.cuda.get_device_name(0)}))
'''


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root),
                           str(Path(__file__).resolve().parent.parent
                               / "chip_smoke.py")],
                          capture_output=True, text=True)
    res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    if not res:
        raise RuntimeError(f"{root}: {proc.stderr[-2000:]}")
    return json.loads(res[0][7:])


def main():
    if len(sys.argv) not in (3, 4):
        print(__doc__)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    pairs = int(sys.argv[3]) if len(sys.argv) == 4 else 10
    medians = {"A": [], "B": []}     # per pair: {workload: median ms}
    for i in range(pairs):
        got = {}
        for side in ("AB" if i % 2 == 0 else "BA"):
            res = run(roots[side])
            got[side] = {k: statistics.median(v) for k, v in res["ms"].items()}
            print(json.dumps({"pair": i, "side": side,
                              "root": str(roots[side]), **res}), flush=True)
        for side in "AB":
            medians[side].append(got[side])
    summary = {}
    for name in medians["A"][0]:
        a = [m[name] for m in medians["A"]]
        b = [m[name] for m in medians["B"]]
        summary[name] = dict(
            a_ms=a, b_ms=b, a_median=statistics.median(a),
            b_median=statistics.median(b),
            pairs_b_faster=sum(y < x for x, y in zip(a, b)), pairs=pairs)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
