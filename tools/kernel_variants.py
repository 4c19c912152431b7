#!/usr/bin/env python3
"""Time variants of the port's redesigned kernels on one NVIDIA GPU.

    python3 tools/kernel_variants.py '{"name": [["csrc/file.cu", "old", "new"], ...], ...}'

An exploratory tool for trying tile and schedule choices by source edits;
no check runs it, and ``chip_smoke.py --kernel-times`` is the timing that
compares trees.

Each variant is a copy of ``hygrid_tpu_torch/`` under the git-ignored
``build/variants/<name>/`` with the listed exact-text edits applied to its
sources (each ``old`` must occur once; ``[]`` is the package as it
stands).  The copies are built in parallel (each by its own
``kernels/_build.py``, into its own build directory), then each is timed
in a process of its own:

* the bf16 fused stack at P-512 (16x256x256x16, 11 layers, radius 2):
  per call by CUDA events (5 calls, 3 times), the kernel alone by
  ``torch.profiler``, 2 and 6 layers, 8 samples, whether it is bit-equal
  to chained ``hex_conv_layer`` launches and the tile the C side chose;
* chained ``hex_conv_layer`` launches at the same stack;
* ``shift_resample`` and ``plan_gather`` on the device alone (CUDA-graph
  replay) at the 4K mosaic's plan (C=3) and the 720p rect->hex plan at
  b=8, float32 and bfloat16, and whether the shift kernel matches its
  plain version (bit for bit at the mosaic, max abs difference at 720p);
* ``plan_gather`` on the device alone (the best of 3 graph replays) at
  ``chip_smoke.KT_GATHER``'s plans (the main paths' plans of phases 3 and
  11), its grid (``resample.last_launch()``) and its max abs difference to
  ``apply_plan``.

Prints the registers and spills ptxas reports for each variant's fused,
shift and plan-gather kernels, then one ``<name> {json}`` line per
variant.  A variant whose edits break bit-equality is still timed: it is
a measurement, not a candidate.  Needs the GPU; the script imports no JAX.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "variants"

TIMING = r'''
import functools, json, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke as smoke
from hygrid_tpu_torch.kernels import conv_stack as cs, resample, \
    resample_shift as rs
from hygrid_tpu_torch.ops import geometry, sampling
from hygrid_tpu_torch.viz import render
from torch.profiler import ProfilerActivity, profile
assert cs.__file__.startswith(sys.argv[1]), cs.__file__
gen = torch.Generator(device="cuda").manual_seed(21)
_, ks = smoke.build_pipeline((512, 512), 16, 10, 2, torch.bfloat16)
relus = [True] * 10 + [False]
xs = torch.randn((16, 256, 256, 16), generator=gen, device="cuda").bfloat16()
out = {}


def fused(x=xs, n=len(ks)):
    return cs.hex_conv_fused_stack(x, ks[:n], radius=2,
                                   relus=[True] * (n - 1) + [False])


def chained():
    v = xs
    for k, r in zip(ks, relus):
        v = cs.hex_conv_layer(v, k, radius=2, relu=r)
    return v


with torch.inference_mode():
    out["fused_equal"] = torch.equal(fused(), chained())
    out["plan"] = dict(cs.LAST_FUSED_PLAN)
    out["fused_ms"] = [smoke.cuda_ms(torch, fused, iters=5) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused()
        torch.cuda.synchronize()
    out["fused_kernel_ms"] = sum(
        getattr(e, "device_time_total", 0) for e in prof.key_averages()
        if "fused_stack_mma" in e.key) / 5 / 1e3
    for n in (2, 6):
        out[f"fused_L{n}_ms"] = smoke.cuda_ms(
            torch, functools.partial(fused, n=n), iters=5)
    out["fused_b8_ms"] = smoke.cuda_ms(
        torch, functools.partial(fused, xs[:8].contiguous()), iters=5)
    out["chained_ms"] = [smoke.cuda_ms(torch, chained, iters=5)
                         for _ in range(2)]
    for label, plan, lead in (
            ("mosaic", render._mosaic_sample_plan(540, 960, 2160, 3840, 0,
                                                  None), (3,)),
            ("720p_b8", geometry.rect_to_hex_plan(720, 1280, 360, 640,
                                                  "bilinear"), (8, 3))):
        x32 = torch.rand(lead + plan.src_shape, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, tag = x32.to(dt), f"{label}_{str(dt)[6:]}"
            got = rs.shift_resample(x, plan)
            want = rs.shift_resample_plain(x, plan)
            out[f"shift_{tag}_matches"] = (
                torch.equal(got, want) if plan.exact_select
                else float((got.float() - want.float()).abs().max()))
            out[f"shift_{tag}_ms"] = smoke.graph_ms(
                torch, functools.partial(rs.shift_resample, x, plan))
            out[f"plan_gather_{tag}_ms"] = smoke.graph_ms(
                torch, functools.partial(resample.plan_gather, x, plan))
    # plan_gather at the main paths' plans, on the device alone, and
    # whether it matches its plain version (max abs difference)
    for label, (kind, *args), lead, dt in smoke.KT_GATHER:
        plan = getattr(geometry, f"{kind}_plan")(*args)
        x = torch.rand(lead + plan.src_shape, generator=gen,
                       device="cuda").to(torch.bfloat16 if dt == "bf16"
                                         else torch.float32)
        got = resample.plan_gather(x, plan)
        out[f"plan_gather_{label}_matches"] = float(
            (got.float() - sampling.apply_plan(x, plan).float()).abs().max())
        out[f"plan_gather_{label}_launch"] = resample.last_launch()
        out[f"plan_gather_{label}_ms"] = min(smoke.graph_ms(
            torch, functools.partial(resample.plan_gather, x, plan))
            for _ in range(3))
print("RESULT", json.dumps(out))
'''

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from hygrid_tpu_torch.kernels import _build; _build.load_library(); "
         "print(_build.build_info.get('log', ''))")


def ptxas_notes(log: str):
    """ptxas's registers and spills for the fused, shift and plan-gather
    kernels."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "fused_stack_mma" in line or "shift_resample_kernel" in line
                or "plan_gather_kernel" in line):
            name = line.split("'")[1] if "'" in line else line
            notes = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "Used" in x or "spill" in x]
            yield name[-70:], "; ".join(notes)


def main():
    variants = json.loads(sys.argv[1])
    procs = {}
    for name, edits in variants.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(ROOT / "hygrid_tpu_torch", d / "hygrid_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for fname, old, new in edits:
            p = d / "hygrid_tpu_torch" / fname
            text = p.read_text()
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                                 f"times in {fname}")
            p.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", BUILD, str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            continue
        built.append(name)
        for kernel, note in ptxas_notes(log):
            print(f"{name}: ptxas {kernel}: {note}", flush=True)
    for name in built:
        run = subprocess.run(
            [sys.executable, "-c", TIMING, str(OUT / name), str(ROOT)],
            capture_output=True, text=True)
        res = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT")]
        print(f"{name} " + (res[0][7:] if res else
                            json.dumps({"failed": run.stderr[-3000:]})),
              flush=True)
    return 0 if len(built) == len(variants) else 1


if __name__ == "__main__":
    sys.exit(main())
