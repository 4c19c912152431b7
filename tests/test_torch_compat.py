"""The port's reference-named modules, ``compat`` and namespace against
``hygrid_tpu``'s: each alias module exports exactly its twin's names; the
``compat`` functions on a small float32 image (``device="cpu"``) within
1e-5 of the reference's; the shader stand-in's mosaic bit-equal to the
reference's; the top-level and ``nn`` namespaces hold every name of the
reference's."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hygrid_tpu as hg
import hygrid_tpu_torch as tg
from hygrid_tpu import compat as jcompat
from hygrid_tpu_torch import compat as tcompat

ALIASES = ["HexFrames", "HexModules", "HexImage", "Image", "geometry",
           "geometry_np", "geometry_torch", "HexPixelArt",
           "HexPixelArt.hexagon_mosaic_shader", "HexPixelArt.texture",
           "HexPixelArt.window", "compat"]


@pytest.mark.parametrize("name", ALIASES)
def test_alias_module_exports_the_reference_names(name):
    ref = importlib.import_module(f"hygrid_tpu.{name}")
    port = importlib.import_module(f"hygrid_tpu_torch.{name}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for attr in port.__all__:
        assert getattr(port, attr) is not None, attr


def test_namespaces_hold_the_reference_names():
    assert set(hg.__all__) <= set(tg.__all__)
    assert set(hg.nn.__all__) <= set(tg.nn.__all__)
    assert set(hg.parallel.__all__) <= set(tg.parallel.__all__)
    assert set(hg.utils.__all__) <= set(tg.utils.__all__)
    assert tg.HexSpec(5, 7) == tg.lattice.HexSpec(5, 7)


def _image():
    return np.random.default_rng(0).random((3, 12, 14)).astype(np.float32)


H = np.array([[1.2, 0.1, 0.0], [-0.1, 0.9, 0.0], [0.0, 0.0, 1.0]])
# name -> (port call, reference call)
CASES = {
    "image_geometric_transformation": (
        lambda x: tcompat.image_geometric_transformation(
            x, H, "linear", device="cpu"),
        lambda x: jcompat.image_geometric_transformation(x, H, "linear")),
    "image_geometric_transformation_gpu": (
        lambda x: tcompat.image_geometric_transformation_gpu(
            x, H, "linear", device="cpu"),
        lambda x: jcompat.image_geometric_transformation_gpu(x, H, "linear")),
    "image_geometric_transformation_cpu": (
        lambda x: tcompat.image_geometric_transformation_cpu(x, H, "nearest"),
        lambda x: jcompat.image_geometric_transformation_cpu(x, H, "nearest")),
    "hex_to_rect_resample": (
        lambda x: tcompat.hex_to_rect_resample(x, (20, 24), "linear",
                                               device="cpu"),
        lambda x: jcompat.hex_to_rect_resample(x, (20, 24), "linear")),
    "hex_to_square_resample": (
        lambda x: tcompat.hex_to_square_resample(x, (20, 24), "linear",
                                                 device="cpu"),
        lambda x: jcompat.hex_to_square_resample(x, (20, 24), "linear")),
    "rect_to_hex_resample": (
        lambda x: tcompat.rect_to_hex_resample(x, (6, 7), "bilinear",
                                               device="cpu"),
        lambda x: jcompat.rect_to_hex_resample(x, (6, 7), "bilinear")),
    "hexresize": (
        lambda x: tcompat.hexresize(x, (9, 10), "linear", device="cpu"),
        lambda x: jcompat.hexresize(x, (9, 10), "linear")),
    "heximpad": (
        lambda x: tcompat.heximpad(x, padding=2, device="cpu"),
        lambda x: jcompat.heximpad(x, padding=2)),
    "hex_impad_to_multiple": (
        lambda x: tcompat.hex_impad_to_multiple(x, 8, device="cpu"),
        lambda x: jcompat.hex_impad_to_multiple(x, 8)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_compat_matches_reference(name):
    port, ref = CASES[name]
    x = _image()
    got, want = port(x), np.asarray(ref(x))
    if name.endswith(("_gpu", "_cpu", "square_resample")):
        assert isinstance(got, np.ndarray)
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


# the numpy-returning shims on a bfloat16 image: the port returns float32
# (numpy has no bfloat16; the cast is exact), the reference an ml_dtypes
# bfloat16 array, compared here cast to float32.  The port blends bf16 in
# float32 and rounds once where the reference blends in bf16 (a deliberate
# difference), so the bound is one bf16 rounding step of the values: 1e-2
# of the largest value (bf16 keeps 8 significant bits, a step of 2**-7).
BF16_REL = 1e-2
BF16_CASES = {
    "hex_to_square_resample": (
        lambda x: tcompat.hex_to_square_resample(x, (32, 32), "linear",
                                                 device="cpu"),
        lambda x: jcompat.hex_to_square_resample(x, (32, 32), "linear")),
    "image_geometric_transformation_gpu": (
        lambda x: tcompat.image_geometric_transformation_gpu(
            x, H, "linear", device="cpu"),
        lambda x: jcompat.image_geometric_transformation_gpu(x, H, "linear")),
    "image_geometric_transformation_cpu": (
        lambda x: tcompat.image_geometric_transformation_cpu(x, H, "linear"),
        lambda x: jcompat.image_geometric_transformation_cpu(x, H, "linear")),
}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_compat_numpy_shims_take_bfloat16(name):
    port, ref = BF16_CASES[name]
    x = np.random.default_rng(16).random((3, 16, 16)).astype(np.float32)
    got = port(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(ref(jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_mosaic_shader_stand_in_matches_reference():
    from hygrid_tpu.HexPixelArt import hexagon_mosaic_shader as jshader
    from hygrid_tpu_torch.HexPixelArt import hexagon_mosaic_shader as tshader
    img = _image()
    outs = []
    for mod, kw in ((jshader, {}), (tshader, {"device": "cpu"})):
        shader = mod.Hexagon_Mosaic_shader().use()
        shader.setUniform("hexmosaicSizeRatio", 0.5)
        shader.setUniform("even_odd_offset", 0)
        shader.setAttrib("position", None)
        outs.append(np.asarray(shader.render(img, (40, 48), **kw)))
    np.testing.assert_array_equal(outs[1], outs[0])
