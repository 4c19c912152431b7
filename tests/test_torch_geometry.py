"""The port's resampling plans and geometry ops against hygrid_tpu.

Plans (idx, weights) must be bit-equal: both packages build them in float64
numpy from the same formulas.  Outputs agree in float32 within 1e-6 (only
the summation order of the blend differs), and match the reference goldens
within the 5e-6 that hygrid_tpu's own golden tests use.
"""
import os

import numpy as np
import pytest
import torch

import hygrid_tpu as hg
from hygrid_tpu.ops import geometry as jgeo
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.ops import sampling as tsamp
from hygrid_tpu_torch.kernels import resample
from hygrid_tpu_torch.utils.profiling import counts
import hygrid_tpu_torch as pt

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "geometry_goldens.npz")
TOL_F32 = 1e-6
TOL_GOLDEN = 5e-6

H_SCALE = np.array([[1.6, 0.0, 0.0], [0.0, 0.7, 0.0], [0.0, 0.0, 1.0]])
H_AFFINE = np.array([[0.9, 0.3, 1.0], [-0.2, 1.1, -2.0], [0.0, 0.0, 1.0]])

# (op, source (h, w), op arguments after the image, cache key tail)
CASES = [
    ("rect_to_hex", (512, 512), ((256, 256), "bilinear"),
     (256, 256, "bilinear", False, "reference")),
    ("rect_to_hex", (32, 32), ((16, 16), "bilinear"),
     (16, 16, "bilinear", False, "reference")),
    ("rect_to_hex", (17, 13), ((9, 15), "nearest"),
     (9, 15, "nearest", False, "reference")),
    ("rect_to_hex", (17, 13), ((9, 15), "nearest", 0, False, "euclidean"),
     (9, 15, "nearest", False, "euclidean")),
    ("rect_to_hex", (20, 18), ((11, 9), "bilinear", 0, True),
     (11, 9, "bilinear", True, "reference")),
    ("hex_to_rect", (256, 256), ((512, 512), "linear"),
     (512, 512, "linear")),
    ("hex_to_rect", (17, 13), ((14, 19), "linear"), (14, 19, "linear")),
    ("hex_to_rect", (17, 13), ((14, 19), "nearest"), (14, 19, "nearest")),
    ("hex_to_rect", (16, 12), ((9, 21), "bilinear"), (9, 21, "bilinear")),
    ("hexresize", (17, 13), ((23, 11), "linear"), (23, 11, "linear")),
    ("hexresize", (11, 8), ((15, 6), "nearest"), (15, 6, "nearest")),
    ("hexresize", (12, 10), ((7, 13), "bilinear"), (7, 13, "bilinear")),
    ("warp", (17, 13), (H_SCALE, "linear"), ("linear", H_SCALE.tobytes())),
    ("warp", (17, 13), (H_AFFINE, "linear"), ("linear", H_AFFINE.tobytes())),
    ("warp", (14, 9), (H_AFFINE, "nearest"), ("nearest", H_AFFINE.tobytes())),
    ("warp", (14, 9), (np.eye(3), "bilinear"),
     ("bilinear", np.eye(3).tobytes())),
]
OPS = {"rect_to_hex": "rect_to_hex_resample",
       "hex_to_rect": "hex_to_rect_resample",
       "hexresize": "hexresize", "warp": "image_geometric_transformation"}


def _ids(case):
    op, (h, w), args, _ = case
    return f"{op}-{h}x{w}-{args[1]}-{args[0] if op != 'warp' else 'H'}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plan_bit_equal(case):
    op, (h, w), args, tail = case
    img = np.random.default_rng(0).random((h, w)).astype(np.float32)
    getattr(hg, OPS[op])(img, *args)
    getattr(pt, OPS[op])(torch.from_numpy(img), *args)
    key = (op, h, w) + tail
    want, got = jgeo._PLAN_CACHE[key], tgeo._PLAN_CACHE[key]
    assert got.idx.dtype == np.int32 and got.weights.dtype == np.float32
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.src_shape == want.src_shape
    assert tuple(got.out_shape) == tuple(want.out_shape)
    assert got.exact_select == want.exact_select


@pytest.mark.parametrize("case", [c for c in CASES if c[1][0] < 64],
                         ids=[_ids(c) for c in CASES if c[1][0] < 64])
def test_output_matches_jax_f32(case):
    op, (h, w), args, _ = case
    img = np.random.default_rng(1).random((2, 3, h, w)).astype(np.float32)
    want = np.asarray(getattr(hg, OPS[op])(img, *args))
    got = getattr(pt, OPS[op])(torch.from_numpy(img), *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32, rtol=0)


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


@pytest.mark.parametrize("name,call", [
    ("r2h_nearest", lambda im, g: pt.rect_to_hex_resample(im, (9, 15), "nearest")),
    ("r2h_bilinear", lambda im, g: pt.rect_to_hex_resample(im, (9, 15), "bilinear")),
    ("resize_linear", lambda im, g: pt.hexresize(im, (23, 11), "linear")),
    ("h2r_linear", lambda im, g: pt.hex_to_rect_resample(im, (14, 19), "linear")),
    ("warp_linear", lambda im, g: pt.image_geometric_transformation(
        im, g["warp_H"], "linear")),
    ("warp_rot_linear", lambda im, g: pt.image_geometric_transformation(
        im, g["warp_Hr"], "linear")),
])
def test_goldens(g, name, call):
    out = call(torch.from_numpy(g["img_a"]).float(), g)
    np.testing.assert_allclose(out.numpy(), g[name], atol=TOL_GOLDEN)


def test_golden_uint8_nearest_exact(g):
    out = pt.rect_to_hex_resample(torch.from_numpy(g["img_u8"]), (9, 15),
                                  "nearest")
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), g["r2h_u8_nearest"].astype(np.uint8))


def test_2d_input_squeezed(g):
    img2d = torch.from_numpy(g["img_a"][0]).float()
    out = pt.rect_to_hex_resample(img2d, (8, 6), "bilinear")
    assert tuple(out.shape) == (8, 6)
    want = np.asarray(hg.rect_to_hex_resample(g["img_a"][0], (8, 6), "bilinear"))
    np.testing.assert_allclose(out.numpy(), want, atol=TOL_F32)


def test_warp_output_shape():
    for h, w in [(17, 13), (30, 7)]:
        for H in (None, H_SCALE, H_AFFINE):
            assert tgeo.warp_output_shape(h, w, H) == jgeo.warp_output_shape(h, w, H)


def test_bf16_blends_in_f32_and_rounds_once():
    """Deliberate difference from hygrid_tpu (which blends bf16 in bf16):
    a bf16 image is blended in float32 and rounded once."""
    plan = tgeo.rect_to_hex_plan(32, 32, 16, 16, "bilinear")
    x = torch.from_numpy(np.random.default_rng(2).random((2, 3, 32, 32))
                         ).to(torch.bfloat16)
    got = tsamp.apply_plan(x, plan)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tsamp.apply_plan(x.float(), plan).to(torch.bfloat16))


def test_apply_plan_auto_runs_plain_version_on_cpu():
    plan = tgeo.hex_to_rect_plan(12, 10, 20, 18, "linear")
    x = torch.from_numpy(np.random.default_rng(3).random((3, 12, 10))).float()
    before = counts().get("plan_gather", 0)
    assert torch.equal(tsamp.apply_plan_auto(x, plan), tsamp.apply_plan(x, plan))
    assert counts().get("plan_gather", 0) == before


def test_plan_device_copies_are_cached():
    plan = tgeo.rect_to_hex_plan(20, 20, 10, 10, "bilinear")
    idx, w = plan.tensors("cpu")
    again = plan.tensors(torch.device("cpu"))
    assert again[0] is idx and again[1] is w
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (4, 100)


def test_plan_gather_wrapper_refuses_other_devices():
    plan = tgeo.rect_to_hex_plan(8, 8, 4, 4, "bilinear")
    with pytest.raises(ValueError, match="no kernel for device"):
        resample.plan_gather(torch.empty((3, 8, 8), device="meta"), plan)


def test_wrong_source_shape_raises():
    plan = tgeo.rect_to_hex_plan(8, 8, 4, 4, "bilinear")
    with pytest.raises(ValueError, match="plan source"):
        tsamp.apply_plan(torch.zeros((3, 8, 9)), plan)


@pytest.mark.parametrize("op", list(OPS.values()))
def test_array_input_goes_to_the_device_asked_for(op):
    """A numpy array lands on ``device`` (the card by default, as
    hygrid_tpu puts it on JAX's default device); a tensor stays where it
    is."""
    args = {"rect_to_hex_resample": ((5, 4), "bilinear"),
            "hex_to_rect_resample": ((9, 7), "linear"),
            "hexresize": ((7, 6), "linear"),
            "image_geometric_transformation": (H_SCALE, "linear")}[op]
    img = np.random.default_rng(5).random((3, 8, 6)).astype(np.float32)
    fn = getattr(pt, op)
    got = fn(img, *args, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, fn(torch.from_numpy(img), *args))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fn(img, *args)
