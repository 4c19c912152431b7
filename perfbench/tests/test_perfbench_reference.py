"""The plain reference against the port's CPU path at small sizes, and the
control and the planted faults failing the cells' comparison."""
import json

import numpy as np
import pytest
import torch

from hygrid_tpu_torch.models import (HexCNN, HexUNet, create_train_state,
                                     hexify_batch, train_step)
from hygrid_tpu_torch.nn.functional import hex_tap_table
from perfbench import programs
from perfbench.reference import hexcnn, hexlib, hexunet
from perfbench.tests import tiny

CELLS = [w["name"] for w in
         json.load(open(tiny.ROOT / "BENCHMARK.json"))["workloads"]]


def _cell(name):
    return json.load(open(tiny.ROOT / "perfbench" / "cells" / f"{name}.json"))


def _random_params(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=g) - 0.5)
    return {k: v.detach().clone() for k, v in model.named_parameters()}


@pytest.mark.parametrize("radius", [2, 3])
def test_taps_are_the_ports_same_conv_taps(radius):
    table = hex_tap_table(radius)
    for parity in (0, 1):
        assert hexlib.hex_taps(radius, parity) == [tuple(t) for t in
                                                  table[parity].tolist()]


def test_resample_is_the_ports_bilinear_hexify():
    x = torch.rand(2, 3, 40, 36)
    idx, wts = (torch.from_numpy(a) for a in
                hexlib.rect_to_hex_plan(40, 36, 20, 18))
    got = hexlib.apply_plan(x, idx, wts, (20, 18))
    torch.testing.assert_close(got, hexify_batch(x, plain=True), rtol=0,
                               atol=0)


def test_hexcnn_forward_matches_the_port():
    m = HexCNN(num_classes=10, channels=(8, 16, 16), depth=2, norm="GN",
               device="cpu")
    params = _random_params(m)
    x = hexify_batch(torch.rand(3, 3, 34, 30))
    cfg = dict(channels=[8, 16, 16], depth=2, radius=2, groups=8)
    torch.testing.assert_close(hexcnn.forward(params, x, cfg), m(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(34, 30), (40, 44)])
def test_hexunet_forward_matches_the_port(hw):
    m = HexUNet(num_classes=4, widths=(8, 16, 16), norm="GN", device="cpu")
    params = _random_params(m, 1)
    x = hexify_batch(torch.rand(2, 3, *hw))
    cfg = dict(widths=[8, 16, 16], depth=1, radius=2, groups=8)
    torch.testing.assert_close(hexunet.forward(params, x, cfg), m(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,labels", [("hexcnn", (4,)),
                                           ("hexunet", (4, 16, 16))])
def test_training_steps_match_the_port(family, labels):
    from perfbench.families import hexcnn as fc, hexunet as fu
    fam = {"hexcnn": fc, "hexunet": fu}[family]
    cfg = json.load(open(tiny.ROOT / "perfbench" / "configs" /
                         f"{family}_small.json"))
    cfg.update(image=[32, 32], hex=[16, 16])
    model = fam.build(cfg, torch.float32, "cpu", None)
    w = _random_params(model, 2)
    ref = programs.RefTrainer(fam, cfg, w, chunk=3)
    state = create_train_state(model)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        x = torch.rand(4, 3, 32, 32, generator=g)
        y = torch.randint(0, cfg["num_classes"], labels, generator=g)
        _, metrics = train_step(state, hexify_batch(x), y)
        loss = ref.step(x, y)
        torch.testing.assert_close(loss, metrics["loss"], rtol=1e-5, atol=0)
    for name, p in model.named_parameters():
        torch.testing.assert_close(ref.p[name].detach(), p.detach(),
                                   rtol=1e-4, atol=1e-6)


def test_float8_rounding_keeps_a_scale_a_tensor():
    t = torch.tensor([1e-3, 2.0, -300.0])
    r = hexlib.Rounding("fp8").op(t)
    assert float(r[2]) == -300.0 and abs(float(r[0]) - 1e-3) < 1e-3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -10)])
    got = hexlib.Rounding("tf32").op(t)
    assert got.tolist() == [1.0, 1 + 2 ** -9, -(1 + 2 ** -10)]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct_at_a_small_size(cell):
    assert tiny.run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, fails the cell's comparison."""
    out = tiny.run(cell, "control:" + _cell(cell)["control"])
    assert not out["correct"], out["checks"]


FAULTS = [(c, f) for c in CELLS for f in
          (("state_unchanged", "half_batch") if "train" in c
           else ("half_batch", "altered_answer"))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """The rest of a run, the look for the card skipped, with the timed
    path broken underneath: a step that leaves the state as it was, half
    of the batch left out (its mean taken over the rest), an answer
    altered where it is produced."""
    out = tiny.run(cell, "fault:" + fault)
    assert not out["correct"], out["checks"]
