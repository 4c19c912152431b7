"""The harness's arithmetic and discovery on the CPU: FLOP counts, the
roofline bound, the busy union, the window's rate and tail, finding cells,
mixes and metrics by name, the result line, and BENCHMARK.json's shape."""
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import types

import pytest
import torch

from perfbench import devtrace, harness, roofline
from perfbench.families import hexcnn, hexunet
from perfbench.tests import tiny

BENCH = json.load(open(tiny.ROOT / "BENCHMARK.json"))
CFG = {n: json.load(open(tiny.ROOT / "perfbench" / "configs" / f"{n}.json"))
       for n in ("hexcnn_small", "hexunet_small")}


def test_hexcnn_small_forward_flops_by_hand():
    # hex 256x256, pooled to 128x127 and 64x63; 7 taps, 2 FLOPs a product
    cells = [256 * 256] * 2 + [128 * 127] * 2 + [64 * 63] * 2
    chans = [(3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128)]
    want = sum(2 * 7 * n * a * b for n, (a, b) in zip(cells, chans))
    want += 2 * 128 * 10
    layers = hexcnn.layers(CFG["hexcnn_small"], 1, (256, 256))
    assert roofline.model_flops(layers, training=False) == want
    assert 3.80e9 < want < 3.86e9
    # a step: the forward, dW everywhere, dx but for the first layer
    first = 2 * 7 * 256 * 256 * 3 * 32
    assert roofline.model_flops(layers, training=True) == 3 * want - first


def test_hexunet_small_forward_flops_by_hand():
    enc = 2 * 7 * (65536 * 3 * 32 + 16256 * 32 * 64 + 4032 * 64 * 128)
    up = 2 * 7 * (4032 * 128 * 64 + 16256 * 64 * 32)
    dec = 2 * 7 * (16256 * 128 * 64 + 65536 * 64 * 32)
    head = 2 * 65536 * 32 * 4
    layers = hexunet.layers(CFG["hexunet_small"], 1, (256, 256))
    assert roofline.model_flops(layers, training=False) == enc + up + dec + head
    assert 5.6e9 < enc + up + dec + head < 5.8e9


def test_the_pooled_sizes_are_the_ports():
    from hygrid_tpu_torch.nn.functional import hex_pool2d
    x = torch.zeros(1, 1, 256, 256)
    y = hex_pool2d(x, "max", kernel_size=2, stride=2, device="cpu")
    assert tuple(y.shape[-2:]) == hexcnn.pooled(256, 256) == (128, 127)


@pytest.mark.parametrize("nbytes,flops", [(1e9, 1e12), (5e9, 1e10), (0, 3e12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_bound_is_chip_smokes(nbytes, flops, dtype):
    sys.path.insert(0, str(tiny.ROOT))
    import chip_smoke
    ms, by = chip_smoke.bound(nbytes, flops,
                              {"float32": "f32", "bfloat16": "bf16"}[dtype])
    s, by2 = roofline.bound(nbytes, flops, dtype)
    assert by == by2 and math.isclose(s * 1e3, ms, rel_tol=1e-12)
    parts = [roofline.bound(nbytes, flops, dtype)] * 3
    assert (roofline.summed_bound(parts)["bound_s"] * 1e3 ==
            pytest.approx(chip_smoke.summed_bound([(ms, by)] * 3)["bound_ms"]))


def _event(name, start, end, device=False, total=0.0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        device_time_total=total)


def test_busy_is_the_union_of_overlapping_kernels():
    assert devtrace.union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    events = [_event("k1", 90, 120, True), _event("k2", 110, 130, True),
              _event("k3", 150, 160, True), _event("span", 0, 300),
              _event("span", 95, 200, True)]
    busy = devtrace.Busy(events, 250e-6)
    assert busy.busy_s == pytest.approx((40 + 10) * 1e-6)
    assert busy.device_ops()[0] == ["k1", pytest.approx(30e-6)]
    events = [_event(devtrace.WINDOW_SPAN, 100, 200),
              _event("k1", 90, 120, True), _event("k2", 110, 130, True),
              _event("k3", 150, 160, True), _event("k4", 195, 230, True),
              _event("op", 100, 140, total=45.0),
              _event("op", 140, 199, total=10.0),
              _event("other", 100, 199, total=99.0),
              _event("wait", 125, 149)]
    ops = devtrace.Ops(events)
    assert ops.op_device_s(["op"]) == pytest.approx(55e-6)
    gaps = dict((n, s) for n, s in ops.idle_gaps())
    assert gaps["wait"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)


def _run(kind, calls, seconds, latency, enqueue):
    cell = types.SimpleNamespace(loop=types.SimpleNamespace(KIND=kind),
                                 traffic={"batch": 32, "trace_calls": 4})
    window = dict(calls=calls, seconds=seconds, latency_s=latency,
                  enqueue_s=enqueue)
    return harness.Run(cell, "bfloat16", 12.5, window,
                       hexcnn.layers(CFG["hexcnn_small"], 32, (256, 256)),
                       probe=dict(enqueue_s=enqueue[:9] + [1.0]))


def test_rate_and_tail_over_the_whole_window():
    lat = [i / 1000 for i in range(1, 201)]            # 1..200 ms
    run = _run("serve", 200, 4.0, lat, [0.002] * 200)
    read = {m: harness.metric_reader(m, tiny.ROOT)(run) for m in
            ("serve_images_per_s", "serve_p95_ms", "setup_s",
             "train_images_per_s", "host_enqueue_ms.serve",
             "step_mfu.serve", "device_idle_pct.serve",
             "conv_fwd_roofline_pct.serve")}
    assert read["serve_images_per_s"] == 200 * 32 / 4.0
    assert read["serve_p95_ms"] == pytest.approx(190.0)
    assert read["setup_s"] == 12.5
    assert read["train_images_per_s"] is None
    assert read["host_enqueue_ms.serve"] == pytest.approx(2.0)
    flops = roofline.model_flops(run.layers, False) * 200 / 4.0
    assert read["step_mfu.serve"] == pytest.approx(100 * flops / 989e12)
    assert read["device_idle_pct.serve"] is None      # no trace
    assert read["conv_fwd_roofline_pct.serve"] is None


def test_a_training_run_reads_a_steps_operations():
    run = _run("train", 50, 2.0, [0.02] * 50, [0.01] * 50)
    read = harness.metric_reader("step_mfu.train", tiny.ROOT)(run)
    flops = roofline.model_flops(run.layers, True) * 50 / 2.0
    assert read == pytest.approx(100 * flops / 989e12)
    assert harness.metric_reader("serve_images_per_s", tiny.ROOT)(run) is None


def test_a_metric_named_for_a_loop_lists_only_that_loops_cells():
    """``<quantity>.train`` and ``<quantity>.serve`` share a reader that
    reads the run's own loop, so BENCHMARK.json's ``workloads`` decide
    which cells report each."""
    for m in BENCH["per_layer"]:
        part = m["name"].rsplit(".", 1)[-1]
        if part in ("train", "serve"):
            for w in m["workloads"]:
                assert harness.find_cell(w, tiny.ROOT).loop.KIND == part


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(harness.RunError):
        harness.metric_reader("no_such_metric.train", tiny.ROOT)


def test_every_cell_and_metric_is_found_by_name():
    for work in BENCH["workloads"]:
        cell = harness.find_cell(work["name"], tiny.ROOT)
        assert cell.loop.KIND in ("train", "serve")
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"], tiny.ROOT))


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new traffic mix and a cell, as data files and a BENCHMARK.json
    entry, run with no code changed."""
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "hexcnn_small.serve_f32_depth3",
                               "config": "hexcnn_small",
                               "traffic": "serve_f32_depth3", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve" in m["name"]:
            m["workloads"].append("hexcnn_small.serve_f32_depth3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.load(open(tiny.ROOT / "perfbench" / "traffic" /
                         "serve_bf16_b128.json"))
    mix.update(dtype="float32", depth=3)
    (tmp_path / "perfbench" / "traffic" / "serve_f32_depth3.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench" / "cells" /
     "hexcnn_small.serve_f32_depth3.json").write_text(
        json.dumps({"control": "bf16", "limits": {"logits": 1e-3}}))
    out = tiny.run("hexcnn_small.serve_f32_depth3", root=tmp_path)
    assert out["correct"] and out["checks"]["logits"]["value"] < 1e-4
    assert {"serve_images_per_s", "serve_p95_ms",
            "setup_s"} == set(out["metrics"])


def test_the_result_lines_keys():
    out = tiny.run("hexcnn_small.serve_bf16", trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"platform", "kind", "count", "memory_peak_bytes",
            "busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) == {"step_mfu.serve", "host_enqueue_ms.serve",
                                   "device_idle_pct.serve"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    json.dumps(out)
    out = tiny.run("hexunet_small.train_f32")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        cfg = json.load(open(tiny.ROOT / c["file"]))
        assert c["file"].startswith("perfbench/") and cfg["reduced"] == c["reduced"]
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    metric_names = list(e2e)
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        metric_names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len(set(metric_names)) == len(metric_names)
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["layer"].split(" (")[0] not in layers or \
            layers[m["layer"].split(" (")[0]] == m["layer"]
        layers[m["layer"].split(" (")[0]] = m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs on the card)")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hexcnn_small.serve_bf16", "--seed", "4294967311", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_no_card_no_result():
    """Without a card, a run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hexcnn_small.serve_bf16", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tiny.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's own
    files, a run exits non-zero and prints no result line."""
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hexcnn_small.serve_bf16", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
