#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hygrid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card, its power
   limit and the torch / CUDA versions;
2. build: compiles ``hygrid_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. kernel A (plan_gather) against its plain version on the rect->hex
   512^2->256^2 bilinear plan and the hex->rect 256^2->512^2 linear plan,
   b=32, C=3, float32 and bfloat16, with kernel and plain times;
4. kernel B (hex_conv_layer) against its plain version at the six
   HexCNN-small layer shapes, b=32, GroupNorm(8) + ReLU, float32 and
   bfloat16, with kernel and plain times;
5. the slice: HexCNN-small (norm="GN", bf16, random weights from a seed)
   serves distinct b=32 batches of 512^2 RGB images, rect->hex included;
   the launch counters must show one kernel-A launch and six kernel-B
   layers per request, the logits must be finite, and one request must
   agree with the plain path run in float32 on the card.

The last lines are the kernel summary, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32
N_REQUESTS = 4
# (Cin, Cout, H, W) of the six conv layers of HexCNN-small on 512^2 input
LAYERS = [(3, 32, 256, 256), (32, 32, 256, 256), (32, 64, 128, 127),
          (64, 64, 128, 127), (64, 128, 64, 63), (128, 128, 64, 63)]
TOL = {"a_f32_abs": 1e-6, "a_bf16_rel": 1e-2, "b_f32_rel": 1e-4,
       "b_bf16_rel": 3e-2, "slice_rel": 5e-2}


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want):
    """(max abs error, max abs error relative to max |want|), in float32."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def check_kernel_a(torch, gen):
    from hygrid_tpu_torch.kernels import resample
    from hygrid_tpu_torch.ops import geometry, sampling
    cases = [("rect->hex 512^2->256^2 bilinear", (512, 512),
              geometry.rect_to_hex_plan(512, 512, 256, 256, "bilinear")),
             ("hex->rect 256^2->512^2 linear", (256, 256),
              geometry.hex_to_rect_plan(256, 256, 512, 512, "linear"))]
    summary = None
    for name, (h, w), plan in cases:
        x32 = torch.rand((BATCH, 3, h, w), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = resample.plan_gather(x, plan)
            want = sampling.apply_plan(x, plan)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"plan_gather {name}: shape/dtype {got.shape} {got.dtype}")
            err, rel = max_err(got, want)
            if dtype == torch.float32:
                require(err <= TOL["a_f32_abs"],
                        f"plan_gather {name} f32: max abs err {err}")
            else:
                require(rel <= TOL["a_bf16_rel"],
                        f"plan_gather {name} bf16: relative err {rel}")
            ms = cuda_ms(torch, lambda: resample.plan_gather(x, plan))
            plain = cuda_ms(torch, lambda: sampling.apply_plan(x, plan))
            log(f"plan_gather {name} K={plan.idx.shape[0]} b={BATCH} C=3 "
                f"{str(dtype)[6:]}: max_abs_err={err!r} rel={rel!r} "
                f"kernel_ms={ms!r} plain_ms={plain!r}")
            if summary is None and dtype == torch.bfloat16:
                summary = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    return summary


def check_kernel_b(torch, gen):
    from hygrid_tpu_torch.kernels import conv_stack
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    kn = hex_kernel_num(2)
    errs, ms_sum, plain_sum = [], 0.0, 0.0
    for li, (cin, cout, h, w) in enumerate(LAYERS):
        groups = math.gcd(8, cout)
        k = torch.randn((cout, cin, kn), generator=gen, device="cuda") \
            / math.sqrt(cin * kn)
        gamma = 1 + 0.1 * torch.rand((cout,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        x32 = torch.rand((BATCH, h, w, cin), generator=gen, device="cuda")
        norm = ("gn", groups, gamma, beta)
        line = f"hex_conv_layer L{li} {cin}->{cout} {h}x{w} b={BATCH} GN({groups})+ReLU:"
        for dtype in (torch.float32, torch.bfloat16):
            x, kd = x32.to(dtype), k.to(dtype)

            def kernel():
                return conv_stack.hex_conv_layer(x, kd, radius=2, norm=norm,
                                                 relu=True)

            def plain():
                return conv_stack.hex_conv_layer_plain(x, kd, radius=2,
                                                       norm=norm, relu=True)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"hex_conv_layer L{li}: shape/dtype {got.shape} {got.dtype}")
            err, rel = max_err(got, want)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            require(rel <= tol, f"hex_conv_layer L{li} {dtype}: relative "
                                f"err {rel} > {tol}")
            ms = cuda_ms(torch, kernel, iters=5)
            pms = cuda_ms(torch, plain, iters=5)
            line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                     f"kernel_ms={ms!r} plain_ms={pms!r};")
            if dtype == torch.bfloat16:
                errs.append(err)
                ms_sum += ms
                plain_sum += pms
        log(line)
    return dict(max_abs_err=max(errs), ms=ms_sum, plain_ms=plain_sum)


def run_slice(torch):
    from hygrid_tpu_torch.kernels import conv_stack, resample
    from hygrid_tpu_torch.models import hexcnn_small, hexify_batch
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                         generator=gen).eval()
    in_gen = torch.Generator(device="cuda").manual_seed(1)
    warm = torch.rand((BATCH, 3, 512, 512), generator=in_gen, device="cuda")
    requests = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                           device="cuda") for _ in range(N_REQUESTS)]

    def serve(batch):
        return model(hexify_batch(batch.to(torch.bfloat16)))

    with torch.inference_mode():
        serve(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resample.LAUNCHES = 0
        conv_stack.LAUNCHES = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = [serve(r) for r in requests]
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        launches = {"plan_gather": resample.LAUNCHES,
                    "hex_conv_layer": conv_stack.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        dev_ms = start.elapsed_time(end)
        require(launches["plan_gather"] == N_REQUESTS,
                f"plan_gather launches {launches['plan_gather']} for "
                f"{N_REQUESTS} requests")
        require(launches["hex_conv_layer"] == 6 * N_REQUESTS,
                f"hex_conv_layer layers {launches['hex_conv_layer']} for "
                f"{N_REQUESTS} requests")
        for i, out in enumerate(logits):
            require(out.shape == (BATCH, 10) and out.dtype == torch.bfloat16,
                    f"request {i}: logits {tuple(out.shape)} {out.dtype}")
            require(bool(torch.isfinite(out).all()),
                    f"request {i}: non-finite logits")
        require(not torch.equal(logits[0], logits[1]),
                "distinct requests returned equal logits")
        ref_model = hexcnn_small(norm="GN", dtype=torch.float32, device="cuda")
        ref_model.load_state_dict(model.state_dict())
        ref = ref_model(hexify_batch(requests[0], plain=True), plain=True)
        err, rel = max_err(logits[0], ref)
        require(rel <= TOL["slice_rel"],
                f"slice logits vs plain f32: relative err {rel}")
    log(f"slice HexCNN-small GN bf16 b={BATCH} 512^2: {N_REQUESTS} requests "
        f"in {dev_ms!r} ms (CUDA events), {wall!r} s host; "
        f"images/s={BATCH * N_REQUESTS / (dev_ms / 1e3)!r}; "
        f"peak_mem_bytes={peak}; launches={launches}; "
        f"logits vs plain f32 max_abs_err={err!r} rel={rel!r}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import hygrid_tpu_torch
    from hygrid_tpu_torch.kernels import _build
    pkg = Path(hygrid_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"hygrid_tpu_torch imported from {pkg}, not from "
                           f"this checkout ({ROOT})")
    require("jax" not in sys.modules, "the port imported jax")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    # full float32 in the plain references: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    kernel = None
    for line in _build.build_info.get("log", "").splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(I\w*?E)?E", line)
        if entry:  # mangled: <length><name>I<template args>E
            kernel = entry.group(1) + (entry.group(2) or "").replace(
                "13__nv_bfloat16", "bf16")
        elif "spill" in line or "registers" in line:
            log(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    with torch.inference_mode():
        a = check_kernel_a(torch, gen)
        b = check_kernel_b(torch, gen)
    launches = run_slice(torch)

    kernels = [
        dict(name="plan_gather", route="cuda",
             source="hygrid_tpu_torch/csrc/plan_gather.cu",
             replaces="hygrid_tpu/kernels/resample_pallas.py:358",
             launches=launches["plan_gather"], **a),
        dict(name="hex_conv_layer", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_layer.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:807",
             launches=launches["hex_conv_layer"], **b),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
