#!/usr/bin/env python3
"""Time variants of the GN/ReLU backward kernel (``csrc/gn_backward.cu``) on
one NVIDIA GPU, and trace where a wave's time goes.

    python3 tools/gn_backward_variants.py [--trace] ['{"name": [["old", "new"], ...], ...}']

An exploratory tool for trying schedule choices by source edits; no check
runs it, and ``chip_smoke.py --kernel-times`` (``gn_bwd``,
``gn_bwd_unet``) is the timing that compares trees.

Each variant is ``gn_backward.cu`` with the listed exact-text edits applied
(``base``: the source as it stands), built alone by one ``nvcc`` each, in
parallel, into a shared library under the git-ignored
``build/gn_backward_variants/<name>/``, and called through ctypes with the
plan ``kernels/conv_stack.gn_backward_plan`` chooses.  Each variant is timed
by CUDA events (10 calls after 2, the wrapper's host work included) at
HexCNN-small's GN layers L0 (32x256x256, C=32), L2 (32x128x127, C=64) and
L4 (32x64x63, C=128) and HexUNet-small's enc0 (8x256x256, C=32) and enc2
(8x64x63, C=128), bf16 gout, and at L0 with float32 gout; beside each time,
whether its gpre and grads are bit-equal to ``base``'s (else their largest
difference over the largest value).

With ``--trace`` the ``base`` source is also built with ``%globaltimer``
stamps (thread 0 of each block, at each phase of each wave, into a device
buffer) and run once at L0, L4 and L0 float32.  For each phase it prints
the mean over blocks, the median over waves, in microseconds: ``reduce``
(the staged chunk's sums, the block's reduction), ``publish`` (the
partial's stores and the counter's release), ``spin`` (until the
sample's counter shows every chunk), ``fold`` (the partials' loads and
sums), ``coef``, ``apply`` (gpre from the staged copy).  The stamps'
resolution is the timer's (256 ns seen on an H100), so the means are
rounded sums of steps.

Prints ptxas' registers and spills per variant, then one ``<name> {json}``
line per variant.  Needs the GPU; the script imports no JAX.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hygrid_tpu_torch.kernels import _build  # noqa: E402
from hygrid_tpu_torch.kernels import conv_stack as cs  # noqa: E402

SRC = ROOT / "hygrid_tpu_torch" / "csrc" / "gn_backward.cu"
OUT = ROOT / "build" / "gn_backward_variants"
LAYERS = {"L0": (32, 32, 256, 256), "L2": (32, 64, 128, 127),
          "L4": (32, 128, 64, 63), "enc0": (8, 32, 256, 256),
          "enc2": (8, 128, 64, 63)}
PHASES = ["reduce", "publish", "spin", "fold", "coef", "apply"]
_STAMP = r'''
__device__ unsigned long long* g_trace;
extern "C" int hg_gn_trace(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define TR(i) if (trp && threadIdx.x == 0) \
  trp[((long long)blockIdx.x * a.waves + w) * 8 + (i)] = gtime();
'''
# the stamps: (text after which, or before which with a leading "<", a
# stamp goes, its index)
TRACE = [
    ("namespace {\n\nconstexpr int kThreads",
     _STAMP + "namespace {\n\nconstexpr int kThreads"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  unsigned long long* const trp = g_trace;\n"),
    ("    float mean[V], rstd[V], scale[V], shift[V], q[2][V];\n",
     "    float mean[V], rstd[V], scale[V], shift[V], q[2][V];\n    TR(0)\n"),
    ("    block_sums<V, 2>(q, red, C, cvs, a.rows, a.shuffle, row, c);\n",
     "    block_sums<V, 2>(q, red, C, cvs, a.rows, a.shuffle, row, c);\n"
     "    TR(1)\n"),
    ("      arrive(a.arrive + it.b);\n",
     "      arrive(a.arrive + it.b);\n      TR(2)\n"),
    ("    wait_for(a.arrive + it.b, a.chunks);\n",
     "    wait_for(a.arrive + it.b, a.chunks);\n    TR(3)\n"),
    ("              csum, red);\n", "              csum, red);\n    TR(4)\n"),
    ("    float mean[V], rstd[V], scale[V], shift[V], a1[V], a2[V];\n",
     "    TR(5)\n    float mean[V], rstd[V], scale[V], shift[V], a1[V], a2[V];\n"),
    ("    __syncthreads();                           // the stage is free\n",
     "    TR(6)\n    __syncthreads();                           // the stage is "
     "free\n"),
]


def build(name, edits):
    """Start the build of one variant; returns (process, library path)."""
    src = SRC.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old[:60]!r} occurs {src.count(old)} "
                             "times")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "gn_backward.cu").write_text(src)
    so = d / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(SRC.parent),
           "-o", str(so), str(d / "gn_backward.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def inputs(gen, b, c, h, w, dtype):
    y = 1.5 * torch.randn((b, h, w, c), generator=gen, device="cuda") + 0.2
    gamma = 1 + 0.1 * torch.rand((c,), generator=gen, device="cuda")
    beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    gout = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    mean, rstd = cs.gn_stats_plain(y, 8)
    return y, mean, rstd, gamma, beta, gout


def call(lib, args, card):
    """The wrapper's launch, on a variant's library."""
    y, mean, rstd, gamma, beta, gout = args
    b, h, w, c = y.shape
    plan = cs.gn_backward_plan(b, h * w, c, gout.element_size(), *card)
    n = cs.gn_backward_scratch(plan, b, c)
    scratch = torch.empty(n, dtype=torch.float32, device="cuda")
    gpre = torch.empty_like(gout)
    grads = torch.empty((3, c), device="cuda")
    fields = (ctypes.c_int * 8)(plan.v, plan.threads, plan.chunk_px,
                                plan.staged_px, plan.chunks, plan.spw,
                                plan.stages, plan.smem)
    status = lib.hg_gn_relu_backward(
        y.data_ptr(), gout.data_ptr(), mean.data_ptr(), rstd.data_ptr(), 1,
        gamma.data_ptr(), beta.data_ptr(), scratch.data_ptr(), n,
        gpre.data_ptr(), grads.data_ptr(), cs._DTYPES[gout.dtype], b, h * w,
        c, 8, 1, cs._EPS, fields, torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"status {status}")
    return plan, gpre, grads


def event_ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace(lib, args, card):
    """Per-phase microseconds: the mean over blocks, median over waves."""
    plan = call(lib, args, card)[0]
    buf = torch.zeros(plan.grid * plan.waves * 8, dtype=torch.int64,
                      device="cuda")
    torch.cuda.synchronize()
    if lib.hg_gn_trace(ctypes.c_void_p(buf.data_ptr())):
        raise RuntimeError("hg_gn_trace")
    call(lib, args, card)
    torch.cuda.synchronize()
    lib.hg_gn_trace(None)
    t = buf.view(plan.grid, plan.waves, 8).double().cpu()
    t = torch.where(t > 0, t / 1e3, torch.full_like(t, float("nan")))
    d = t[:, :, 1:7] - t[:, :, 0:6]
    per_wave = torch.nanmean(d, 0)
    span = torch.nanmean(t[:, :, 6] - t[:, :, 0], 0)
    return dict(plan=plan._asdict(),
                wave_us=float(span.median()),
                **{p: float(per_wave[:, i].median())
                   for i, p in enumerate(PHASES)})


def main():
    args = [a for a in sys.argv[1:] if a != "--trace"]
    variants = {"base": []}
    if args:
        variants.update(json.loads(args[0]))
    if "--trace" in sys.argv:
        variants["trace"] = TRACE
    procs = {n: build(n, e) for n, e in variants.items()}
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)} "
              f"spills {re.findall(r'(\d+) bytes spill stores', log)}",
              flush=True)
        lib = ctypes.CDLL(str(so))
        lib.hg_gn_relu_backward.argtypes = \
            _build._SIGNATURES["hg_gn_relu_backward"]
        lib.hg_gn_relu_backward.restype = ctypes.c_int
        libs[name] = lib
    card = cs.gn_backward_device(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = {k: inputs(gen, *v, torch.bfloat16) for k, v in LAYERS.items()}
    cases["L0_f32"] = inputs(gen, *LAYERS["L0"], torch.float32)
    want = {k: call(libs["base"], v, card)[1:] for k, v in cases.items()}
    for name, lib in libs.items():
        if name == "trace":
            continue
        row = {}
        for k, v in cases.items():
            gpre, grads = call(lib, v, card)[1:]
            torch.cuda.synchronize()
            same = (torch.equal(gpre, want[k][0])
                    and torch.equal(grads, want[k][1]))
            if not same:
                same = max(
                    float((gpre.float() - want[k][0].float()).abs().max()
                          / want[k][0].float().abs().max()),
                    float((grads - want[k][1]).abs().max()
                          / want[k][1].abs().max()))
            row[k] = dict(ms=event_ms(lambda: call(lib, v, card)),
                          equal_to_base=same)
        print(f"{name} {json.dumps(row)}", flush=True)
    if "trace" in libs:
        lib = libs["trace"]
        lib.hg_gn_trace.argtypes = [ctypes.c_void_p]
        lib.hg_gn_trace.restype = ctypes.c_int
        for k in ("L0", "L4", "L0_f32"):
            print(f"trace {k} {json.dumps(trace(lib, cases[k], card))}",
                  flush=True)


if __name__ == "__main__":
    main()
