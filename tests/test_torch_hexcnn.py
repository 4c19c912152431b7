"""The HexCNN inference slice as a whole: hygrid_tpu's flax HexCNN and the
port's HexCNN, the same weights carried by the converter, rect input ->
hexify_batch -> logits.  Float32; relative max-abs error <= 1e-4 (the
norms rescale the convs' summation-order differences).  The per-module
route (BN and the other norms) runs its BN in eval mode on ``batch_stats``
drawn from a seed (flax under ``jax.jit``);
``chip_smoke.build_permodule_hexcnn`` (the kernel route) is held to
``hexcnn_small(norm="BN")``."""
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.nn import layers as TL
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax
from test_torch_modules import random_flax_variables

REL = 1e-4
ROOT = Path(__file__).resolve().parents[1]

# (name, flax constructor kwargs, port constructor kwargs, rect size)
CONFIGS = [
    ("HexCNN-8-16-d2-GN", dict(channels=(8, 16), depth=2, norm="GN"), 32),
    ("hexcnn_tiny-GN", dict(norm="GN"), 64),
    ("HexCNN-8-16-d1-None", dict(channels=(8, 16), depth=1, norm=None), 32),
]


def _flax_model(kw, min_cells):
    if "channels" in kw:
        return jm.HexCNN(stack_min_cells=min_cells, **kw)
    return jm.hexcnn_tiny(stack_min_cells=min_cells, **kw)


def _port_model(kw):
    if "channels" in kw:
        return tm.HexCNN(device="cpu", **kw)
    return tm.hexcnn_tiny(device="cpu", **kw)


def _perturbed_params(model, hexed, seed):
    """Flax params as numpy, with the GN affine and biases moved off their
    ones/zeros init so that the converter's mapping of every leaf counts."""
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(seed), hexed)["params"])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: v + rng.normal(0, 0.1, v.shape).astype(np.float32), params)


@pytest.mark.parametrize("min_cells", [0, 1024])
@pytest.mark.parametrize("name,kw,size", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_hexcnn_logits_match_jax(name, kw, size, min_cells):
    rect = np.random.default_rng(size).random((2, 3, size, size)).astype(np.float32)
    hexed = jm.hexify_batch(rect)
    model = _flax_model(kw, min_cells)
    params = _perturbed_params(model, hexed, seed=len(name))
    want = np.asarray(model.apply({"params": params}, hexed))

    port = _port_model(kw)
    port.load_state_dict(hexcnn_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(tm.hexify_batch(torch.from_numpy(rect))).numpy()
    assert got.shape == want.shape == (2, 10)
    assert np.abs(got - want).max() / np.abs(want).max() <= REL


def test_hexify_batch_matches_jax():
    rect = np.random.default_rng(1).random((2, 3, 40, 36)).astype(np.float32)
    want = np.asarray(jm.hexify_batch(rect))
    got = tm.hexify_batch(torch.from_numpy(rect))
    assert tuple(got.shape) == want.shape == (2, 3, 20, 18)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    plain = tm.hexify_batch(torch.from_numpy(rect), plain=True)
    assert torch.equal(plain, got)


def test_converter_maps_every_leaf():
    model = jm.HexCNN(channels=(8, 16), depth=2, norm="GN")
    hexed = jm.hexify_batch(np.zeros((1, 3, 32, 32), np.float32))
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(0), hexed)["params"])
    sd = hexcnn_state_dict_from_flax({"params": params})
    port = tm.HexCNN(channels=(8, 16), depth=2, norm="GN", device="cpu")
    assert sorted(sd) == sorted(port.state_dict())
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  params["head"]["kernel"].T)
    np.testing.assert_array_equal(sd["stage1.kernel_1"].numpy(),
                                  params["stage1"]["kernel_1"])
    port.load_state_dict(sd)  # strict: no missing or unexpected keys


def test_converter_rejects_module_bundles():
    """Module bundles are no longer rejected: a BN HexCNN's params and
    batch_stats map one to one onto the port's per-module route."""
    model = jm.HexCNN(channels=(8, 16), depth=2, norm="BN")
    hexed = jm.hexify_batch(np.zeros((1, 3, 32, 32), np.float32))
    variables = random_flax_variables(model, hexed, 0)
    sd = hexcnn_state_dict_from_flax(variables)
    port = tm.HexCNN(channels=(8, 16), depth=2, norm="BN", device="cpu")
    assert sorted(sd) == sorted(port.state_dict())
    np.testing.assert_array_equal(
        sd["stage1_conv1.conv.kernel"].numpy(),
        variables["params"]["stage1_conv1"]["conv"]["kernel"])
    np.testing.assert_array_equal(
        sd["stage0_conv1.norm.running_var"].numpy(),
        variables["batch_stats"]["stage0_conv1"]["norm"]["BatchNorm_0"]["var"])
    port.load_state_dict(sd)  # strict


def test_model_init_from_generator():
    a = tm.hexcnn_small(norm="GN", device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = tm.hexcnn_small(norm="GN", device="cpu",
                       generator=torch.Generator().manual_seed(3))
    c = tm.hexcnn_small(norm="GN", device="cpu",
                       generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["stage0.kernel_0"], sc["stage0.kernel_0"])
    assert tuple(sa["stage0.kernel_0"].shape) == (32, 3, 7)
    assert tuple(sa["head.weight"].shape) == (10, 128)


def test_bf16_model_runs_in_bf16_and_tracks_f32():
    gen = torch.Generator().manual_seed(0)
    model = tm.hexcnn_tiny(norm="GN", dtype=torch.bfloat16, device="cpu",
                           generator=gen)
    ref = tm.hexcnn_tiny(norm="GN", device="cpu")
    ref.load_state_dict(model.state_dict())
    rect = torch.rand((2, 3, 32, 32), generator=gen)
    with torch.no_grad():
        out = model(tm.hexify_batch(rect.to(torch.bfloat16)))
        want = ref(tm.hexify_batch(rect), plain=True)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 10)
    assert float((out.float() - want).abs().max() / want.abs().max()) <= 5e-2


def test_unported_norm_raises():
    """hygrid_tpu's default norm, "BN", builds the per-module route; a
    norm neither package knows raises the reference's KeyError."""
    model = tm.HexCNN(device="cpu")
    assert not model.stacked
    assert hasattr(model, "stage2_conv1")
    assert isinstance(model.stage0_conv0.norm.running_var, torch.Tensor)
    with pytest.raises(KeyError, match="Unrecognized norm type"):
        tm.HexCNN(norm="XN", device="cpu")
    with pytest.raises(KeyError, match="Unrecognized norm type"):
        jm.HexCNN(norm="XN").init(jax.random.key(0),
                                  np.zeros((1, 3, 8, 8), np.float32))


PERMODULE = [("BN", True), ("SyncBN", True), ("LN", True), ("IN", True),
             ("GN", False), (None, False)]


@pytest.mark.parametrize("norm,use_stack", PERMODULE,
                         ids=[f"{n}-stack{u}" for n, u in PERMODULE])
def test_permodule_hexcnn_logits_match_jax(norm, use_stack):
    rect = np.random.default_rng(7).random((2, 3, 32, 32)).astype(np.float32)
    hexed = jm.hexify_batch(rect)
    model = jm.HexCNN(channels=(8, 16), depth=2, norm=norm,
                      use_stack=use_stack)
    variables = random_flax_variables(model, hexed, 3)
    want = np.asarray(jax.jit(model.apply)(variables, hexed))
    port = tm.HexCNN(channels=(8, 16), depth=2, norm=norm,
                     use_stack=use_stack, device="cpu")
    assert not port.stacked
    port.load_state_dict(hexcnn_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port(tm.hexify_batch(torch.from_numpy(rect))).numpy()
    assert got.shape == want.shape == (2, 10)
    assert np.abs(got - want).max() / np.abs(want).max() <= REL


def test_bn_hexcnn_train_mode_matches_jax():
    """``train=True`` normalises with batch statistics and updates the
    running statistics as flax's mutable ``batch_stats`` do."""
    rect = np.random.default_rng(9).random((2, 3, 32, 32)).astype(np.float32)
    hexed = jm.hexify_batch(rect)
    model = jm.HexCNN(channels=(8, 16), depth=2, norm="BN")
    variables = random_flax_variables(model, hexed, 5)
    want, updates = jax.jit(functools.partial(
        model.apply, train=True, mutable=["batch_stats"]))(variables, hexed)
    port = tm.HexCNN(channels=(8, 16), depth=2, norm="BN", device="cpu")
    port.load_state_dict(hexcnn_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port(tm.hexify_batch(torch.from_numpy(rect)), train=True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= REL
    after = hexcnn_state_dict_from_flax(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               updates["batch_stats"])})
    state = port.state_dict()
    stats = [k for k in after if ".running_" in k]
    assert len(stats) == 8
    for key in stats:
        assert float((state[key] - after[key]).abs().max()) <= 1e-5, key


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_permodule_kernel_route_matches_jax():
    """chip_smoke's route (b): hexcnn_small(norm="BN") with every HexConv2d
    on impl="pallas", against hygrid_tpu.models.hexcnn_small(norm="BN") at
    a small size."""
    rect = np.random.default_rng(8).random((2, 3, 32, 32)).astype(np.float32)
    hexed = jm.hexify_batch(rect)
    model = jm.hexcnn_small(norm="BN")
    variables = random_flax_variables(model, hexed, 4)
    want = np.asarray(jax.jit(model.apply)(variables, hexed))
    port = _chip_smoke().build_permodule_hexcnn(device="cpu").eval()
    convs = [m for m in port.modules() if isinstance(m, TL.HexConv2d)]
    assert len(convs) == 6 and all(m.impl == "pallas" for m in convs)
    port.load_state_dict(hexcnn_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port(tm.hexify_batch(torch.from_numpy(rect))).numpy()
    assert got.shape == want.shape == (2, 10)
    assert np.abs(got - want).max() / np.abs(want).max() <= REL


def test_bn_route_convs_run_in_float32_under_bf16():
    """HexConvModule passes no dtype to its conv, so under dtype=bf16 the
    convs and BN compute in float32 and only the head is bf16."""
    model = tm.hexcnn_tiny(norm="BN", dtype=torch.bfloat16, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    seen = []
    for name, mod in model.named_modules():
        if name.endswith(".conv") or name.endswith(".norm"):
            mod.register_forward_hook(
                lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    with torch.no_grad():
        out = model(torch.rand((2, 3, 16, 16)))
    assert out.dtype == torch.bfloat16
    assert len(seen) == 4
    assert all(o == torch.float32 for _, o in seen)
