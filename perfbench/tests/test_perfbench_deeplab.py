"""The HexDeepLabV3 family on the CPU: its training steps against the plain
reference, its layer shapes against the port's, its operations by hand,
and the new per-layer metrics' readers on a run without a trace."""
import json
import types

import torch

from hygrid_tpu_torch.models import create_train_state, hexify_batch, train_step
from hygrid_tpu_torch.nn.functional import hex_conv2d_output_shape, hex_pool2d
from perfbench import harness, programs, roofline
from perfbench.families import hexdeeplab
from perfbench.tests import tiny

CFG = json.load(open(tiny.ROOT / "perfbench" / "configs" /
                     "hexdeeplabv3_r50.json"))
NEW = ("residual_roofline_pct.train", "resize_roofline_pct.train",
       "resize_bwd_roofline_pct.train", "strided_conv_roofline_pct.train")


def test_training_steps_match_the_port():
    """Three AdamW steps of the family's model at its published widths on
    16 x 16 hex cells against the reference's, as
    ``test_training_steps_match_the_port`` holds the other families: the
    losses, the first gradient (from the optimizer's first moment) within
    1e-4 of each leaf's largest entry, and the parameters after the steps
    within 5e-5 (AdamW's step of 1e-3 is normalised, so a weight whose
    gradient is round-off moves by a share of it that the two sides' sums
    decide: its 33 M weights hold a few such)."""
    cfg = dict(CFG, image=[32, 32], hex=[16, 16])
    model = hexdeeplab.build(cfg, torch.float32, "cpu", None)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=g) - 0.5)
    w = {k: v.detach().clone() for k, v in model.named_parameters()}
    ref = programs.RefTrainer(hexdeeplab, cfg, w, chunk=3)
    state = create_train_state(model)
    for step in range(3):
        x = torch.rand(4, 3, 32, 32, generator=g)
        y = torch.randint(0, cfg["num_classes"], (4, 16, 16), generator=g)
        _, metrics = train_step(state, hexify_batch(x), y)
        loss = ref.step(x, y)
        torch.testing.assert_close(loss, metrics["loss"], rtol=1e-5, atol=0)
        if step == 0:
            want = ref.first_grads()
            for name, p in model.named_parameters():
                got = state.optimizer.state[p]["exp_avg"] / (1 - programs.B1)
                torch.testing.assert_close(
                    got, want[name], rtol=0,
                    atol=1e-4 * float(want[name].abs().max()))
    for name, p in model.named_parameters():
        torch.testing.assert_close(ref.p[name].detach(), p.detach(),
                                   rtol=1e-4, atol=5e-5)


def test_the_sizes_are_the_ports():
    for h, w in [(512, 512), (16, 16), (24, 32), (13, 9), (8, 8)]:
        assert hexdeeplab.strided(h, w) == hex_conv2d_output_shape(
            h, w, 2, stride=2, padding=1)
        assert hexdeeplab.strided(h, w) == hex_conv2d_output_shape(
            h, w, 1, stride=2, padding=0)
        stem = hexdeeplab.strided(h, w)         # the pool's input
        y = hex_pool2d(torch.zeros(1, 1, *stem), "max", kernel_size=3,
                       stride=2, padding=1, device="cpu")
        assert tuple(y.shape[-2:]) == hexdeeplab.pooled3(*stem)


def test_operations_by_hand():
    """82.18 GFLOP an image forward (the stem, four bottleneck stages,
    ASPP's branches and projection, the classifier, the resize), 245.57 a
    training step; 59 conv layers, 16 joins; the logits at 32 x 32 cells."""
    layers = hexdeeplab.layers(CFG, 1, (512, 512))
    assert sum(l["op"] in ("conv", "sconv") for l in layers) == 59
    assert sum(l["op"] == "join" for l in layers) == 16
    assert layers[-1]["src"] == [32, 32]
    stem = 2 * 37 * 256 * 256 * 3 * 64
    assert roofline.layer_flops(layers[0]) == stem
    fwd = roofline.model_flops(layers, training=False)
    assert 82.17e9 < fwd < 82.19e9
    assert 245.5e9 < roofline.model_flops(layers, training=True) < 245.6e9


def test_the_new_metrics_read_nothing_without_a_trace():
    cell = harness.find_cell("hexdeeplabv3_r50.train_bf16", tiny.ROOT)
    run = harness.Run(cell, "bfloat16", 1.0,
                      dict(calls=3, seconds=1.0, latency_s=[], enqueue_s=[]),
                      hexdeeplab.layers(cell.cfg, 64, (512, 512)))
    for name in NEW:
        assert harness.metric_reader(name, tiny.ROOT)(run) is None


def test_the_new_metrics_bounds():
    """Each reader's bound from the layers, on a trace whose spans took one
    second each: the joins' 6 e n c bytes, the resize's and its backward's
    bytes, the strided convs' longer of bytes and operations."""
    cell = harness.find_cell("hexdeeplabv3_r50.train_bf16", tiny.ROOT)
    layers = hexdeeplab.layers(cell.cfg, 64, (512, 512))
    trace = types.SimpleNamespace(op_device_s=lambda names: 1.0 * len(names))
    run = harness.Run(cell, "bfloat16", 1.0, {}, layers, trace=trace)
    calls = cell.traffic["trace_calls"]
    joins = sum(6 * 2 * l["n"] * l["cout"] for l in layers if l["op"] == "join")
    read = harness.metric_reader("residual_roofline_pct.train", tiny.ROOT)
    assert abs(read(run) - 100 * joins / 3.35e12 * calls / 2.0) < 1e-9
    out = 64 * 21 * 512 * 512
    bwd = harness.metric_reader("resize_bwd_roofline_pct.train", tiny.ROOT)
    assert abs(bwd(run) - 100 * 2 * (out + 64 * 21 * 1024) / 3.35e12
               * calls) < 1e-9
    fwd = harness.metric_reader("resize_roofline_pct.train", tiny.ROOT)
    assert abs(fwd(run) - 100 * 2 * (out + 64 * 21 * 1024) / 3.35e12
               * calls) < 1e-9
    sconv = harness.metric_reader("strided_conv_roofline_pct.train", tiny.ROOT)
    assert sconv(run) > 0


def test_the_rounded_reference_in_the_programs_place_reads_one():
    """``grad_rounded`` divides the program's median leaf gap by the rounded
    reference's: with that reference as the program (the CPU computes it
    the same way twice) the two medians are one number, and the loop's
    other numbers are :mod:`train`'s."""
    from perfbench.loops import train, train_rounded
    out = tiny.run("hexcnn_small.train_bf16", "control:bf16")
    assert out["checks"]["grad_rounded"]["value"] == 1.0
    cell = harness.find_cell("hexcnn_small.train_bf16", tiny.ROOT)
    assert cell.loop is train_rounded and cell.loop.KIND == train.KIND
