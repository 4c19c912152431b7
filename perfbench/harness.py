"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the plain reference, the result line.

Everything a cell is made of is found by name (the repository root's
``BENCHMARK.json`` names the cell's configuration and traffic mix):

* ``configs/<config>.json``: the model's sizes; its ``family`` names
  ``families/<family>.py`` (the port's constructor, the layer shapes) and,
  through it, ``reference/<family>.py``;
* ``traffic/<traffic>.json``: the mix's parameters; its ``loop`` names
  ``loops/<loop>.py``, which makes the run's inputs from the seed, builds
  the program it drives, and holds its set-up, call and comparison;
* ``cells/<cell>.json``: the limits of the numbers compared;
* ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning
  the metric's value or None where the run has nothing for it; a metric
  ``<quantity>.<part>`` without a file of its own is read by
  ``metrics/<quantity>.py``, for the run's own loop.

No list of cells, mixes or metrics is written in code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import devtrace
from .inputs import DTYPES, make_weights
from .loops import run_window, synchronize
from .programs import load_weights
from .reference.hexlib import float32_exact

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hygrid_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    family: object
    loop: object
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: Path, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files loaded;
    ``overrides`` replace entries of its traffic and configuration (the
    CPU tests' small sizes)."""
    bench = _json(root / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    data = root / "perfbench"
    cfg = _json(data / "configs" / f"{work['config']}.json")
    traffic = _json(data / "traffic" / f"{work['traffic']}.json")
    limits = _json(data / "cells" / f"{name}.json")["limits"]
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    family = importlib.import_module(f"perfbench.families.{cfg['family']}")
    loop = importlib.import_module(f"perfbench.loops.{traffic['loop']}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, work["chips"], cfg, traffic, limits, family, loop,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def metric_reader(name: str, root: Path):
    """``metrics/<name>.py``'s ``read``, or for ``<quantity>.<part>``
    without a file of its own, ``metrics/<quantity>.py``'s."""
    folder = root / "perfbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise RunError(f"metric {name!r} has no reader in {folder}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{path.stem.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------------- the run

@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    dtype: str
    setup_s: float
    window: dict
    layers: list
    probe: dict | None = None
    trace: devtrace.Trace | None = None


def _precision(dtype: str):
    """A float32 mix runs in float32, as its configuration states: TF32
    off for cuBLAS and cuDNN, whose convolutions (the port's transposed
    convs among them) torch's defaults let round their operands to TF32."""
    return float32_exact() if dtype == "float32" else contextlib.nullcontext()


def check_device(chips: int) -> str:
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: the benchmark "
                       "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return "cuda"


def check_port() -> None:
    """The port imports from the checkout that holds this harness."""
    try:
        import hygrid_tpu_torch
    except ImportError as exc:
        raise RunError(f"the port does not import: {exc}") from exc
    where = Path(hygrid_tpu_torch.__file__).resolve()
    if HERE.parent not in where.parents:
        raise RunError(f"hygrid_tpu_torch imports from {where}, outside the "
                       f"checkout {HERE.parent}")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(name: str, seed: int, seconds: float, trace: bool, *, root: Path,
        t_start: float, device: str | None = None, program: str = "port",
        overrides: dict | None = None, log=None,
        details: dict | None = None) -> dict:
    """One run of cell ``name`` of ``root``'s ``BENCHMARK.json`` (its data
    files under ``root/perfbench``); returns the result line's object.
    ``device`` None looks for the card (and fails without it); the CPU
    tests pass ``"cpu"`` with small ``overrides``.  ``details``, where
    given, receives every number the loop's check computed."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = find_cell(name, root, overrides)
    if device is None:
        device = check_device(cell.chips)
    check_port()
    t = cell.traffic

    def stage(what):
        log(f"{what}: {time.perf_counter() - t_start:.3f} s")

    stage("imports")
    with _precision(t["dtype"]):
        gen = torch.Generator(device=device).manual_seed(0)
        model = cell.family.build(cell.cfg, DTYPES[t["dtype"]], device, gen)
        stage("the device's context and the model")
        weights = make_weights({n: tuple(p.shape) for n, p in
                                model.named_parameters()}, seed, device)
        load_weights(model, weights)
        feed = cell.loop.make_feed(cell, seed, device)
        try:
            prog = cell.loop.program(cell, model, weights, device, program)
        except ValueError as exc:
            raise RunError(str(exc)) from exc
        del model
        stage("weights, inputs and the program")
        readings = cell.loop.setup(prog, feed, t, weights, device)
        setup_s = time.perf_counter() - t_start
        stage("set-up (the warm-up calls)")

        keep = cell.loop.keeper(seed, t)
        call = cell.loop.call(prog, feed)
        window = run_window(call, t["warmup"], device, t["depth"],
                            seconds=seconds, keep=keep)
        log(f"window: {window['calls']} calls in {window['seconds']:.4f} s")
        layers = cell.family.layers(cell.cfg, t["batch"], cell.cfg["hex"])
        record = Run(cell, t["dtype"], setup_s, window, layers)
        breakdown = None
        if trace:
            first = t["warmup"] + window["calls"]
            record.probe = run_window(call, first, device, 1,
                                      calls=t["probe_calls"])
            record.trace = _traced_window(call, t, device,
                                          first + t["probe_calls"])
            breakdown = record.trace.breakdown()
        dev = _device_info(device, cell.chips)
        if record.trace is not None:
            dev.update(busy_s=record.trace.busy_s,
                       window_s=record.trace.window_s)
        del prog, call
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = cell.loop.check(cell.family, cell.cfg, t, weights, feed,
                              readings, keep)
    if details is not None:
        details.update(numbers)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in cell.limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    failed = sum(any(not item[k] <= lim for k, lim in cell.limits.items()
                     if k in item) for item in numbers["items"])

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": window["calls"],
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _profiled(activities, warm, active):
    """``active()`` under ``torch.profiler`` after ``warm()`` under it
    unrecorded; returns the active part's events and ``active()``'s
    result."""
    from torch.profiler import profile, schedule
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        prof.step()
        out = active()
        prof.step()
    return prof.events(), out


def _traced_window(call, traffic: dict, device, first: int):
    """``trace_calls`` calls traced on the device alone (the busy share),
    then as many traced with the host's ops (the time under each op, and
    what the host did in the idle gaps), each after two calls that warm the
    profiler up."""
    from torch.profiler import ProfilerActivity, record_function
    n, depth = traffic["trace_calls"], traffic["depth"]
    cuda = torch.device(device).type == "cuda"

    def warm(at):
        return lambda: run_window(call, at, device, depth, calls=2)

    events, window = _profiled(
        [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU],
        warm(first), lambda: run_window(call, first + 2, device, depth,
                                        calls=n))
    busy = devtrace.Busy(events, window["seconds"])

    def spanned():
        with record_function(devtrace.WINDOW_SPAN):
            run_window(call, first + n + 4, device, depth, calls=n,
                       traced=True)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    events, _ = _profiled(acts, warm(first + n + 2), spanned)
    return devtrace.Trace(busy, devtrace.Ops(events))


def _device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    synchronize(device)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "power": _power_limit()}


def main(argv, t_start: float, root: Path) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  root=root, t_start=t_start)
    except RunError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
