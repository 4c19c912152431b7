"""The port's spans and counters (``utils/profiling.py``) and the benchmark's
readers of them, on the CPU.

* Off: without a profiler :func:`span` is one shared null context, and a
  ``train_step`` of a tiny HexUNet enters no ``record_function``.
* On: under a ``torch.profiler`` that records the host's ops, a step and a
  request hold the spans the benchmark reads; every layer span nests under
  one ``hygrid.train_step`` or ``hygrid.forward``; each top-level span
  carries an identifier of its own; spans of one name never nest;
  ``hygrid.gn_backward`` runs under the layer's autograd node, on the
  backward's thread.
* The registry: ``count`` / ``counts`` under threads, the entry points'
  counts, and no launch counter left in a kernel module's globals.
* The readers (``perfbench/metrics``): each new one on tiny traced runs
  (None on the CPU, which launches no kernel), their bounds by hand from the
  layer shapes over a stand-in trace, and the transposed conv's output
  shape against the port's.
"""
import collections
import importlib
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hygrid_tpu_torch import kernels
from hygrid_tpu_torch.models import (HexUNet, create_train_state,
                                     hexify_batch, train_step)
from hygrid_tpu_torch.nn import experimental as E
from hygrid_tpu_torch.utils import profiling
from perfbench import harness, roofline
from perfbench.families import hexcnn as fam_hexcnn
from perfbench.families import hexunet as fam_hexunet
from perfbench.tests import tiny

LAYER_SPANS = ("hygrid.pool", "hygrid.conv_transpose",
               "hygrid.conv_transpose.subconv", "hygrid.gn_backward")
CALL_SPANS = ("hygrid.train_step", "hygrid.forward")
NEW_METRICS = ("pool_roofline_pct", "upsample_roofline_pct",
               "upsample_copy_pct", "gn_bwd_roofline_pct",
               "resample_roofline_pct", "kernel_calls",
               "pool_bwd_roofline_pct")


def _tiny_unet():
    gen = torch.Generator().manual_seed(3)
    model = HexUNet(num_classes=4, widths=(8, 16), device="cpu",
                    generator=gen)
    rect = torch.rand((2, 3, 32, 32), generator=gen)
    labels = torch.randint(0, 4, (2, 16, 16), generator=gen)
    return model, rect, labels


@pytest.fixture(scope="module")
def traced():
    """The host events of two training steps and one request of a tiny
    HexUNet, recorded with their inputs."""
    model, rect, labels = _tiny_unet()
    state = create_train_state(model)
    train_step(state, hexify_batch(rect), labels)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        for _ in range(2):
            train_step(state, hexify_batch(rect), labels)
        with torch.inference_mode():
            model.eval()(hexify_batch(rect))
    return [e for e in p.events() if e.name.startswith("hygrid")
            or e.name == "_HexConvLayerBackward"]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p)
        p = p.cpu_parent
    return out


# ------------------------------------------------------------------- off

def test_span_is_the_shared_null_context_without_a_profiler():
    assert profiling.span("hygrid.a") is profiling.span("hygrid.b", 7)
    with profiling.span("hygrid.a") as inside:
        assert inside is None


def test_a_step_enters_no_record_function_without_a_profiler(monkeypatch):
    """No range of the port's is opened (torch's optimizer opens its own
    ``record_function`` whatever the profiler)."""
    entered = []
    rf = torch.autograd.profiler.record_function
    enter = rf.__enter__

    def spy(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name, *a: entered.append(name))
    monkeypatch.setattr(rf, "__enter__", spy)
    model, rect, labels = _tiny_unet()
    train_step(create_train_state(model), hexify_batch(rect), labels)
    assert not [n for n in entered if "hygrid" in n]


def test_annotate_is_a_span():
    @profiling.annotate("hygrid.test_annotated")
    def double(x):
        return 2 * x

    assert torch.equal(double(torch.ones(2)), torch.full((2,), 2.0))
    with profile(activities=[ProfilerActivity.CPU]) as p:
        double(torch.ones(2))
    found = [e for e in p.events() if e.name == "hygrid.test_annotated"]
    assert len(found) == 1


# -------------------------------------------------------------------- on

@pytest.mark.parametrize("name", ("hygrid.train_step", "hygrid.forward",
                                  "hygrid.hexify") + LAYER_SPANS)
def test_a_step_and_a_request_hold_the_span(traced, name):
    assert any(e.name == name for e in traced)


@pytest.mark.parametrize("name", LAYER_SPANS)
def test_layer_spans_nest_under_one_call_span(traced, name):
    for e in (e for e in traced if e.name == name):
        calls = [a for a in _ancestors(e) if a.name in CALL_SPANS]
        assert calls, name
    # the request's pools and transposed convs sit under its forward alone
    forwards = [e for e in traced if e.name == "hygrid.forward"
                and not any(a.name == "hygrid.train_step"
                            for a in _ancestors(e))]
    assert len(forwards) == 1


def test_top_level_spans_carry_distinct_idents(traced):
    tops = [e for e in traced if e.name.startswith("hygrid.")
            and not any(a.name.startswith("hygrid.") for a in _ancestors(e))]
    assert {e.name for e in tops} == {"hygrid.train_step", "hygrid.forward",
                                      "hygrid.hexify"}
    by_name = collections.defaultdict(list)
    for e in tops:
        ident = e.concrete_inputs[0]
        assert isinstance(ident, int), e.name
        by_name[e.name].append(ident)
    assert by_name["hygrid.hexify"] == sorted(set(by_name["hygrid.hexify"]))
    assert len(by_name["hygrid.hexify"]) == 3
    steps = by_name["hygrid.train_step"]
    assert len(steps) == 2 and steps[1] == steps[0] + 1


def test_spans_of_one_name_never_nest(traced):
    for e in traced:
        if e.name.startswith("hygrid."):
            assert e.name not in {a.name for a in _ancestors(e)}, e.name


def test_gn_backward_runs_under_the_layers_autograd_node(traced):
    gn = [e for e in traced if e.name == "hygrid.gn_backward"]
    # two steps, three GN layers of the stacked route (enc0, enc1, dec0)
    assert len(gn) == 6
    for e in gn:
        node = e.cpu_parent
        assert node.name == "_HexConvLayerBackward"
        assert e.thread == node.thread
        assert not any(a.name == "hygrid.forward" for a in _ancestors(e))


# -------------------------------------------------------------- registry

def test_count_returns_the_total_and_counts_is_a_snapshot(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    assert profiling.count("plan_gather") == 1
    assert profiling.count("plan_gather", 3) == 4
    snap = profiling.counts()
    profiling.count("hex_conv_layer")
    assert snap == {"plan_gather": 4}
    assert profiling.counts() == {"plan_gather": 4, "hex_conv_layer": 1}


def test_counts_lose_no_update_under_threads(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [profiling.count("k") for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counts() == {"k": 32000}


def test_the_entry_points_count_each_call():
    model, rect, labels = _tiny_unet()
    state = create_train_state(model)
    before = profiling.counts()
    train_step(state, hexify_batch(rect), labels)
    with torch.inference_mode():
        model.eval()(hexify_batch(rect))
    after = profiling.counts()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    # the CPU runs the plain versions: no kernel is counted
    assert moved == {"train_step": 1, "forward": 2, "hexify_batch": 2}
    assert set(profiling.CALLS) == {"train_step", "forward", "hexify_batch",
                                    "residual", "hexresize", "conv_strided"}


@pytest.mark.parametrize("module", ("conv_single", "conv_stack", "resample",
                                    "resample_shift"))
def test_no_kernel_module_keeps_a_launch_counter(module):
    mod = importlib.import_module(f"hygrid_tpu_torch.kernels.{module}")
    assert mod.__name__.startswith(kernels.__name__)
    assert not [n for n, v in vars(mod).items()
                if n.endswith("LAUNCHES") and isinstance(v, int)]


# --------------------------------------------------------------- readers

@pytest.mark.parametrize("cell", ("hexcnn_small.train_f32",
                                  "hexunet_small.serve_bf16"))
def test_new_readers_on_tiny_traced_runs(cell):
    out = tiny.run(cell, trace=True, probe_calls=2)
    assert out["correct"]
    part = cell.split(".")[1].split("_")[0]
    wanted = {m["name"] for m in harness.find_cell(cell, tiny.ROOT).per_layer
              if m["name"].split(".")[0] in NEW_METRICS}
    assert wanted >= {f"pool_roofline_pct.{part}",
                      f"resample_roofline_pct.{part}",
                      f"kernel_calls.{part}"}
    # the CPU launches no kernel: every device time and kernel count is 0,
    # so each new reader reads None (its docstring says so)
    assert not wanted & set(out["metrics"])
    assert all(v["value"] <= 100 for v in out["metrics"].values()
               if v["unit"] == "%")


class _Trace:
    def __init__(self, device_s):
        self.device_s = device_s

    def op_device_s(self, names):
        return sum(self.device_s.get(n, 0.0) for n in names)


def _run(config, family, kind, dtype, batch, device_s):
    cell = harness.find_cell(f"{config}.{kind}_"
                             f"{'f32' if dtype == 'float32' else 'bf16'}",
                             tiny.ROOT)
    cell.traffic["batch"] = batch
    layers = family.layers(cell.cfg, batch, tuple(cell.cfg["hex"]))
    return harness.Run(cell, dtype, 1.0, {"calls": 1, "seconds": 1.0},
                       layers, trace=_Trace(device_s))


def _read(metric, run):
    return harness.metric_reader(metric, tiny.ROOT)(run)


def test_pool_bound_by_hand():
    # HexCNN-small, one float32 image: the 2 x 2 windows of 128 x 127 and
    # 64 x 63 outputs, then the global pool over 64 x 63 x 128
    run = _run("hexcnn_small", fam_hexcnn, "train", "float32", 1,
               {"hygrid.pool": 1e-3})
    nbytes = 4 * (32 * (4 + 1) * 128 * 127 + 64 * (4 + 1) * 64 * 63
                  + 128 * (64 * 63 + 1))
    want = 100 * nbytes / roofline.HBM_BYTES_S * 12 / 1e-3
    assert _read("pool_roofline_pct.train", run) == pytest.approx(want)


@pytest.mark.parametrize("config,family", [("hexcnn_small", fam_hexcnn),
                                           ("hexunet_small", fam_hexunet)])
def test_pool_backward_bound_by_hand(config, family):
    # both models' two max-pools, 256 x 256 -> 128 x 127 -> 64 x 63: the
    # output gradient read and the input gradient written (HexCNN's global
    # pool has no such backward)
    run = _run(config, family, "train", "float32", 2,
               {"hygrid.pool_backward": 1e-3, "hygrid.pool": 1.0})
    nbytes = 2 * 4 * (32 * (128 * 127 + 256 * 256)
                      + 64 * (64 * 63 + 128 * 127))
    want = 100 * nbytes / roofline.HBM_BYTES_S * 12 / 1e-3
    assert _read("pool_bwd_roofline_pct.train", run) == pytest.approx(want)
    assert _read("pool_bwd_roofline_pct.train", _run(
        config, family, "serve", "bfloat16", 2,
        {"hygrid.pool_backward": 1e-3})) is None
    assert _read("pool_bwd_roofline_pct.train", _run(
        config, family, "train", "float32", 2, {"hygrid.pool": 1.0})) is None


def test_gn_backward_bound_by_hand():
    run = _run("hexunet_small", fam_hexunet, "train", "float32", 2,
               {"hygrid.gn_backward": 2e-3})
    cells = 2 * (65536 * 32 + 16256 * 64 + 4032 * 128 + 16256 * 64
                 + 65536 * 32)
    want = 100 * 12 * cells / roofline.HBM_BYTES_S * 12 / 2e-3
    assert _read("gn_bwd_roofline_pct.train", run) == pytest.approx(want)
    assert _read("gn_bwd_roofline_pct.train", _run(
        "hexunet_small", fam_hexunet, "serve", "bfloat16", 2,
        {"hygrid.gn_backward": 2e-3})) is None


def test_resample_bound_by_hand():
    # 512^2 -> 256^2 bilinear: 258,060 of the 262,144 pixels have a weight
    run = _run("hexcnn_small", fam_hexcnn, "serve", "bfloat16", 4,
               {"hygrid.hexify": 5e-4})
    nbytes = 2 * 4 * 3 * (258060 + 256 * 256)
    want = 100 * nbytes / roofline.HBM_BYTES_S * 100 / 5e-4
    assert _read("resample_roofline_pct.serve", run) == pytest.approx(want)


@pytest.mark.parametrize("dtype,kind", [("float32", "train"),
                                        ("bfloat16", "serve")])
def test_upsample_bound_by_hand(dtype, kind):
    run = _run("hexunet_small", fam_hexunet, kind, dtype, 1,
               {"hygrid.conv_transpose": 1e-2,
                "hygrid.conv_transpose.subconv": 6e-3})
    e = roofline.ESIZE[dtype]
    want_s = 0.0
    for (h, w), (ho, wo), ci, co in (((64, 63), (127, 125), 128, 64),
                                     ((128, 127), (255, 253), 64, 32)):
        nbytes = e * (h * w * ci + ho * wo * co + ci * co * 7)
        flops = 2 * h * w * ci * co * 7
        want_s += max(nbytes / roofline.HBM_BYTES_S,
                      flops / roofline.PEAK_FLOPS[dtype])
    calls = run.cell.traffic["trace_calls"]
    assert _read(f"upsample_roofline_pct.{kind}", run) == \
        pytest.approx(100 * want_s * calls / 1e-2)
    assert _read(f"upsample_copy_pct.{kind}", run) == pytest.approx(40.0)
    assert _read(f"upsample_roofline_pct.{kind}", _run(
        "hexcnn_small", fam_hexcnn, kind, dtype, 1,
        {"hygrid.conv_transpose": 1e-2})) is None


@pytest.mark.parametrize("hw", [(64, 63), (128, 127), (7, 6), (5, 9)])
def test_tconv_out_is_the_ports_output_shape(hw):
    from perfbench.metrics import upsample_roofline_pct as reader
    x = torch.zeros((1, 4) + hw)
    out = E.hex_conv_transpose2d(x, torch.zeros((2, 4, 7)), radius=2,
                                 stride=2, device="cpu")
    assert tuple(out.shape[-2:]) == reader.tconv_out(*hw, radius=2)


def test_kernel_calls_by_hand(monkeypatch):
    step = {"plan_gather": 1, "hex_conv_layer": 6, "hex_conv_layer_dgrad": 5,
            "hex_conv_layer_wgrad": 6, "gn_relu_backward": 6}
    reg = collections.Counter({k: 17 * v for k, v in step.items()})
    reg.update(train_step=17, forward=17, hexify_batch=17)
    monkeypatch.setattr(profiling, "_COUNTS", reg)
    run = _run("hexcnn_small", fam_hexcnn, "train", "float32", 1, {})
    assert _read("kernel_calls.train", run) == 24
    assert _read("kernel_calls.serve", run) == 24   # reads the run's loop
    reg["forward"] = 34
    serve = types.SimpleNamespace(cell=types.SimpleNamespace(
        loop=types.SimpleNamespace(KIND="serve")))
    assert _read("kernel_calls.serve", serve) == 12
    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter(
        train_step=3, forward=3))
    assert _read("kernel_calls.train", run) is None
