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
  ``apply_plan``;
* the float32 conv passes at HexCNN-small's six layers (b=32, 512^2
  input): kernel B's conv pass with GN (``kernel_b_f32_ms``), dx of layers
  1-5 (``dgrad_f32_ms``) and dW of all six (``wgrad_f32_ms``), each summed
  over its layers by CUDA events, 3 times, and layer by layer
  (``*_layers_ms``; kernel B's conv pass alone by torch.profiler,
  ``kernel_b_f32_conv_pass_layers_ms``); each pass's max relative
  difference to its plain version (``*_rel``) and whether two dW launches
  are bit-equal; the float32 fused P-512 stack (``fused_f32_ms``) and
  whether it is bit-equal to chained layers.

Prints the registers and spills ptxas reports for each variant's fused,
shift, plan-gather and float32 conv kernels, then one ``<name> {json}``
line per variant.  A variant whose edits break bit-equality is still timed: it is
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
# the float32 conv passes at HexCNN-small's layers
f32 = {"kernel_b_f32": [], "dgrad_f32": [], "wgrad_f32": []}
rel = dict.fromkeys(f32, 0.0)
wgrad_equal = True


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


for li, (cin, cout, h, w) in enumerate(smoke.LAYERS):
    x = torch.rand((32, h, w, cin), generator=gen, device="cuda")
    g = torch.randn((32, h, w, cout), generator=gen, device="cuda")
    k = torch.randn((cout, cin, 7), generator=gen, device="cuda") \
        / (cin * 7) ** 0.5
    norm = ("gn", 8, torch.ones(cout, device="cuda"),
            torch.zeros(cout, device="cuda"))
    passes = {"kernel_b_f32": (
        functools.partial(cs.hex_conv_layer, x, k, radius=2, norm=norm,
                          relu=True),
        functools.partial(cs.hex_conv_layer_plain, x, k, radius=2,
                          norm=norm, relu=True)),
        "wgrad_f32": (
        functools.partial(cs.hex_conv_layer_wgrad, x, g, radius=2),
        functools.partial(cs.hex_conv_layer_wgrad_plain, x, g, radius=2))}
    if li:
        passes["dgrad_f32"] = (
            functools.partial(cs.hex_conv_layer_dgrad, g, k, radius=2),
            functools.partial(cs.hex_conv_layer_dgrad_plain, g, k,
                              radius=2))
    # outside inference mode: the plain dW is autograd's
    for name, (kernel, plain) in passes.items():
        got = kernel()
        rel[name] = max(rel[name], _rel(got, plain()))
        if name == "wgrad_f32":
            wgrad_equal = wgrad_equal and torch.equal(got, kernel())
        f32[name].append(kernel)
    del got
with torch.inference_mode():
    for name, fns in f32.items():
        out[f"{name}_ms"] = [sum(smoke.cuda_ms(torch, fn, iters=5)
                                 for fn in fns) for _ in range(3)]
        out[f"{name}_layers_ms"] = [smoke.cuda_ms(torch, fn, iters=5)
                                    for fn in fns]
        out[f"{name}_rel"] = rel[name]
    # kernel B's conv pass alone (torch.profiler), layer by layer
    out["kernel_b_f32_conv_pass_layers_ms"] = [
        smoke._gn_half(torch, fn)[0] for fn in f32["kernel_b_f32"]]
    out["wgrad_f32_equal"] = wgrad_equal
    _, ks32 = smoke.build_pipeline((512, 512), 16, 10, 2, torch.float32)
    xs32 = xs.float()

    def fused32():
        return cs.hex_conv_fused_stack(xs32, ks32, radius=2, relus=relus)

    v = xs32
    for k, r in zip(ks32, relus):
        v = cs.hex_conv_layer(v, k, radius=2, relu=r)
    out["fused_f32_equal"] = torch.equal(fused32(), v)
    out["fused_f32_plan"] = dict(cs.LAST_FUSED_PLAN)
    out["fused_f32_ms"] = [smoke.cuda_ms(torch, fused32, iters=5)
                           for _ in range(3)]
print("RESULT", json.dumps(out))
'''

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from hygrid_tpu_torch.kernels import _build; _build.load_library(); "
         "print(_build.build_info.get('log', ''))")


def ptxas_notes(log: str):
    """ptxas's registers and spills for the fused, shift, plan-gather and
    float32 conv kernels (kernel B's, the fused stack's and the dW's)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "fused_stack" in line or "shift_resample_kernel" in line
                or "plan_gather_kernel" in line
                or "wgrad_partial_kernel" in line
                or "hex_conv_fma_kernel" in line):
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
