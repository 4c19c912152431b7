"""The HexCNN inference slice as a whole: hygrid_tpu's flax HexCNN and the
port's HexCNN, the same weights carried by the converter, rect input ->
hexify_batch -> logits.  Float32; relative max-abs error <= 1e-4 (GroupNorm
rescales the convs' summation-order differences)."""
import jax
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax

REL = 1e-4

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
    tree = {"stage0_conv0": {"conv": {"kernel": np.zeros((2, 2, 7))}},
            "head": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}}
    with pytest.raises(ValueError, match="sub-module"):
        hexcnn_state_dict_from_flax(tree)


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
    with pytest.raises(NotImplementedError, match="HexConvModule"):
        tm.HexCNN()                      # hygrid_tpu's default norm is "BN"
