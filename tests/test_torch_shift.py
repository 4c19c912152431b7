"""The port's shift resampler against hygrid_tpu.

* ``rowsep_decompose`` and ``shift_decompose`` are numpy copies: every field
  is bit-equal to the reference's, and both refuse the same plans.
* ``shift_resample_plain`` (what the wrapper runs on the CPU) agrees with
  the reference's shift executor in Pallas interpret mode (both the
  full-source kernel and the banded one, ``force_banded``) within 1e-5 in
  float32, as the reference's own tests hold it to ``apply_plan``, and
  with the port's ``apply_plan`` within 1e-6 (summation order only).
* bfloat16 within one bf16 ulp of the float32 sum (one rounding); the
  mosaic bit-exact; the gradient equal to ``apply_plan``'s within 1e-6.
* ``apply_plan_auto``'s route, by the plan's structure, on the plans of
  the port's paths.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hygrid_tpu import lattice as jlat
from hygrid_tpu.kernels import resample_pallas as jrp
from hygrid_tpu.kernels import resample_shift as jrs
from hygrid_tpu.ops import geometry as jgeo
from hygrid_tpu.ops import sampling as jsamp
from hygrid_tpu.viz.render import mosaic_plan as jmosaic_plan

from hygrid_tpu_torch.kernels import resample_shift as trs
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.ops import sampling as tsamp
from hygrid_tpu_torch.viz import render as trender

# the five plan families of hygrid_tpu's shift tests
FAMILIES = [
    ("hex", "linear", (96, 128), (96, 128)),
    ("rect", "bilinear", (128, 128), (64, 128)),
    ("hex", "linear", (64, 128), (128, 128)),
    ("rect", "bilinear", (64, 64), (32, 32)),
    ("hex", "nearest", (96, 128), (96, 128)),
]
MOSAIC = (136, 240, 544, 960)


def _ref_plan(kind, method, src, out):
    sh, sw = src
    oh, ow = out
    box = "rect_source" if kind == "rect" else "hex_to_rect"
    gx, gy = jgeo._linspace_grid(jlat.corner_box(box, sh, sw), oh, ow)
    if kind == "rect":
        return jsamp.rect_sample_plan(gx, gy, sh, sw, method)
    return jsamp.hex_sample_plan(gx, gy, sh, sw, method)


def _ref_mosaic_plan():
    th, tw, oh, ow = MOSAIC
    flat, mask = [np.asarray(v) for v in jmosaic_plan(th, tw, oh, ow, 0)]
    return jsamp.SamplePlan(flat[None], mask[None].astype(np.float32),
                            (th, tw), (oh, ow), exact_select=True)


def _port(plan):
    """The same plan as a port SamplePlan (the arrays are bit-equal; the
    geometry tests check the port's own builders)."""
    return tsamp.SamplePlan(np.asarray(plan.idx), np.asarray(plan.weights),
                            tuple(plan.src_shape), tuple(plan.out_shape),
                            plan.exact_select)


PLANS = {f"{k}-{m}-{s[0]}x{s[1]}-{o[0]}x{o[1]}": (lambda c=(k, m, s, o):
                                                  _ref_plan(*c))
         for k, m, s, o in FAMILIES}
PLANS["rect-bilinear-72x128-36x64"] = lambda: _ref_plan(
    "rect", "bilinear", (72, 128), (36, 64))
PLANS["mosaic-136x240-544x960"] = _ref_mosaic_plan

_CACHE = {}


def _plans(name):
    """(reference plan, port plan), built once per test module."""
    if name not in _CACHE:
        ref = PLANS[name]()
        _CACHE[name] = (ref, _port(ref))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(PLANS))
def test_decompositions_bit_equal(name):
    ref, port = _plans(name)
    want = jrp.rowsep_decompose(ref)
    got = trs.rowsep_decompose(port)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = jrs.shift_decompose(ref)
    got = trs.shift_decompose(port)
    assert want is not None and got is not None
    for field in ("num", "den", "slots", "n_phases", "phase_mode"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("wplanes", "rowbase", "phase_idx", "wphase"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _warp_plan():
    h, w = 21, 17
    H = np.array([[0.9, 0.3, 1.0], [-0.2, 1.1, -2.0], [0.0, 0.0, 1.0]])
    return jsamp.hex_sample_plan(*jgeo._warp_grid(h, w, H), h, w, "linear")


def _one_row_plan():
    return _ref_plan("rect", "bilinear", (1, 40), (1, 20))


def _wide_stride_plan():
    # column stride 5:1 is none of the strides the decomposition tries
    return _ref_plan("rect", "bilinear", (32, 200), (16, 40))


@pytest.mark.parametrize("build", [_warp_plan, _one_row_plan,
                                   _wide_stride_plan],
                         ids=["warp", "one-row", "stride-5"])
def test_decomposition_refuses_what_the_reference_refuses(build):
    ref = build()
    port = _port(ref)
    assert (trs.rowsep_decompose(port) is None) == \
        (jrp.rowsep_decompose(ref) is None)
    assert jrs.shift_decompose(ref) is None
    assert trs.shift_decompose(port) is None
    assert not tsamp.takes_shift_route(port, 4)


@pytest.mark.parametrize("force_banded", [False, True])
@pytest.mark.parametrize("kind,method,src,out,lead", [
    ("hex", "linear", (96, 128), (96, 128), (2, 3)),      # phase mode
    ("rect", "bilinear", (128, 128), (64, 128), (3,)),    # dense
    ("hex", "linear", (64, 128), (128, 128), (4, 3)),     # dense
    ("rect", "bilinear", (64, 64), (32, 32), (2, 3)),     # num=2
])
def test_plain_matches_reference_shift_executor(kind, method, src, out, lead,
                                                force_banded):
    ref = _ref_plan(kind, method, src, out)
    port = _port(ref)
    x = np.random.default_rng(17).random(lead + src).astype(np.float32)
    want = np.asarray(jrs.apply_plan_shift(jnp.asarray(x), ref,
                                           force_banded=force_banded))
    got = trs.shift_resample_plain(torch.from_numpy(x), port)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    plain = tsamp.apply_plan(torch.from_numpy(x), port)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
    # the wrapper runs the plain version on a CPU tensor
    assert torch.equal(trs.shift_resample(torch.from_numpy(x), port), got)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    mag = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("name", ["hex-linear-96x128-96x128",
                                  "rect-bilinear-72x128-36x64"])
def test_bf16_within_one_ulp(name):
    _, port = _plans(name)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 3) + port.src_shape).astype(np.float32)).to(torch.bfloat16)
    got = trs.shift_resample(x, port)
    want = tsamp.apply_plan(x.float(), port)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want).abs() <= _bf16_ulp(want)).all())


def test_mosaic_bit_exact():
    ref, port = _plans("mosaic-136x240-544x960")
    geo = trs.shift_decompose_cached(port)
    assert geo.den == 4 and not geo.phase_mode
    rng = np.random.default_rng(23)
    x = (rng.random((3,) + port.src_shape) * 255).astype(np.float32)
    got = trs.shift_resample_plain(torch.from_numpy(x), port)
    assert np.array_equal(got.numpy(),
                          np.asarray(jsamp.apply_plan(jnp.asarray(x), ref)))
    assert torch.equal(got.to(torch.bfloat16),
                       trs.shift_resample(torch.from_numpy(x).to(
                           torch.bfloat16), port))
    u8 = torch.from_numpy((x.astype(np.uint8)))
    out = tsamp.apply_plan_auto(u8, port)
    assert out.dtype == torch.uint8
    assert torch.equal(out, tsamp.apply_plan(u8, port))


@pytest.mark.parametrize("name", ["hex-linear-64x128-128x128",
                                  "rect-bilinear-64x64-32x32"])
def test_grad_matches_apply_plan(name):
    _, port = _plans(name)
    x0 = torch.from_numpy(np.random.default_rng(7).random(
        (2, 3) + port.src_shape).astype(np.float32))
    x1 = x0.clone().requires_grad_(True)
    x2 = x0.clone().requires_grad_(True)
    (trs.shift_resample(x1, port) ** 2).sum().backward()
    (tsamp.apply_plan(x2, port) ** 2).sum().backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), atol=1e-6)


ROUTES = [
    # (path, port plan, reference plan, shift route)
    ("slice A rect->hex 512^2->256^2",
     lambda: tgeo.rect_to_hex_plan(512, 512, 256, 256, "bilinear"),
     lambda: _ref_plan("rect", "bilinear", (512, 512), (256, 256)), False),
    ("bench.py hex->rect 256^2->512^2",
     lambda: tgeo.hex_to_rect_plan(256, 256, 512, 512, "linear"),
     lambda: _ref_plan("hex", "linear", (256, 256), (512, 512)), False),
    ("video 720p rect->hex",
     lambda: tgeo.rect_to_hex_plan(720, 1280, 360, 640, "bilinear"),
     lambda: _ref_plan("rect", "bilinear", (720, 1280), (360, 640)), True),
    ("mosaic",
     lambda: trender._mosaic_sample_plan(*MOSAIC, 0, None),
     _ref_mosaic_plan, True),
]


@pytest.mark.parametrize("path,port_plan,ref_plan,shift", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_follows_plan_structure(path, port_plan, ref_plan, shift):
    """The port takes the shift resampler exactly where the reference's
    TPU routing takes its shift kernel (in bf16, the dtype of these
    paths)."""
    plan = port_plan()
    assert tsamp.takes_shift_route(plan, 2) is shift
    assert jrs.shift_prefers(ref_plan(), 2) is shift


def test_route_skips_pure_row_downsample():
    """Unit column stride with fewer output rows: the reference keeps its
    one-hot kernel there (resample_pallas.py:862-863), the port
    plan_gather."""
    _, port = _plans("rect-bilinear-128x128-64x128")
    geo = trs.shift_decompose_cached(port)
    assert geo.num == geo.den == 1
    assert not tsamp.takes_shift_route(port, 4)


@pytest.mark.parametrize("name", ["hex-linear-96x128-96x128",
                                  "hex-nearest-96x128-96x128"])
def test_route_keeps_unit_stride_plans_on_plan_gather(name):
    """Same-size unit-stride plans are shift-structured but stay on
    plan_gather, as every path before the video and mosaic ran them."""
    _, port = _plans(name)
    geo = trs.shift_decompose_cached(port)
    assert geo.num == geo.den == 1
    assert not tsamp.takes_shift_route(port, 4)


def test_geometry_is_kept_on_its_plan():
    _, port = _plans("rect-bilinear-72x128-36x64")
    geo = trs.shift_decompose_cached(port)
    assert trs.shift_decompose_cached(port) is geo
    assert trs.shift_decompose_cached(_port(_plans(
        "rect-bilinear-72x128-36x64")[0])) is not geo


def test_integer_images_keep_the_reference_rules():
    _, port = _plans("hex-nearest-96x128-96x128")
    rng = np.random.default_rng(3)
    for dtype in (torch.uint16, torch.int32):
        x = torch.from_numpy(rng.integers(0, 1000, (3,) + port.src_shape)
                             .astype(np.int32)).to(dtype)
        out = tsamp.apply_plan_auto(x, port)
        assert out.dtype == dtype and torch.equal(out,
                                                  tsamp.apply_plan(x, port))
    _, blend = _plans("hex-linear-96x128-96x128")
    x = torch.from_numpy(rng.integers(0, 256, (3,) + blend.src_shape)
                         .astype(np.uint8))
    out = tsamp.apply_plan_auto(x, blend)
    assert out.dtype == torch.float32
    assert torch.equal(out, tsamp.apply_plan(x, blend))


def test_wrapper_refuses_what_it_does_not_take():
    port = _port(_warp_plan())
    with pytest.raises(ValueError, match="shift-structured"):
        trs.shift_resample(torch.zeros(port.src_shape), port)
    _, plan = _plans("hex-linear-96x128-96x128")
    with pytest.raises(ValueError, match="no kernel"):
        trs.shift_resample(torch.zeros(plan.src_shape, device="meta"), plan)
