"""The north-star pipeline (``bench.py``'s rect->hex->stack->rect) on the
port, and what its 4K variant runs, against hygrid_tpu on the CPU.

* ``chip_smoke.build_pipeline`` (the port's public functions, bench.py's
  weights) against ``bench.build_pipeline`` at size 32, C=16, 4 layers,
  float32: unfused, fused and plain, within 1e-4 relative (the reference's
  stack runs its Pallas kernel in interpret mode);
* the resample route: ``takes_shift_route`` against the reference's
  ``shift_prefers`` in bf16 and f32 on the paths' plans, and the 4K
  rect->hex leg on ``plan_gather``;
* the resample tiers the TPU bands or phases (``resample_pallas.py`` #2-#4)
  against ``plan_gather``'s plain version within 1e-6 (float32).

Relative errors are max-abs over the largest magnitude of the reference.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu import lattice as jlat
from hygrid_tpu.kernels import resample_pallas as jrp
from hygrid_tpu.kernels import resample_shift as jrs
from hygrid_tpu.ops import geometry as jgeo
from hygrid_tpu.ops import sampling as jsamp
from hygrid_tpu_torch.kernels import resample
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.ops import sampling as tsamp
from hygrid_tpu_torch.viz import render as trender

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("bench"), _load("chip_smoke")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mode", ["kernels", "fused", "plain"])
def test_pipeline_matches_bench(scripts, mode):
    bench, smoke = scripts
    size, channels, layers, radius = 32, 16, 3, 2
    x = np.random.default_rng(3).random((2, 3, size, size)).astype(np.float32)
    want = np.asarray(bench.build_pipeline(size, channels, layers, radius,
                                           jnp.float32)(jnp.asarray(x)))
    pipe, kernels = smoke.build_pipeline(
        (size, size), channels, layers, radius, torch.float32,
        fused=mode == "fused", plain=mode == "plain", device="cpu")
    assert len(kernels) == layers + 1
    got = pipe(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-4


def _ref_plan(kind, method, src, out):
    sh, sw = src
    oh, ow = out
    box = "rect_source" if kind == "rect" else "hex_to_rect"
    gx, gy = jgeo._linspace_grid(jlat.corner_box(box, sh, sw), oh, ow)
    if kind == "rect":
        return jsamp.rect_sample_plan(gx, gy, sh, sw, method)
    return jsamp.hex_sample_plan(gx, gy, sh, sw, method)


@functools.lru_cache(maxsize=None)
def _plans(kind, method, src, out):
    """(port plan, reference plan), built once per module."""
    build = tgeo.rect_to_hex_plan if kind == "rect" else tgeo.hex_to_rect_plan
    return build(*src, *out, method), _ref_plan(kind, method, src, out)


ROUTES = [
    # (path, plan, esz, shift route)
    ("P-4K rect->hex", ("rect", "bilinear", (2160, 3840), (1080, 1920)), 2,
     False),
    ("P-4K rect->hex", ("rect", "bilinear", (2160, 3840), (1080, 1920)), 4,
     False),
    ("video 720p rect->hex", ("rect", "bilinear", (720, 1280), (360, 640)),
     2, True),
    ("video 720p rect->hex", ("rect", "bilinear", (720, 1280), (360, 640)),
     4, True),
    ("1080p rect->hex", ("rect", "bilinear", (1080, 1920), (540, 960)), 2,
     True),
    ("1080p rect->hex", ("rect", "bilinear", (1080, 1920), (540, 960)), 4,
     False),
    ("P-512 rect->hex", ("rect", "bilinear", (512, 512), (256, 256)), 2,
     False),
    ("P-512 hex->rect", ("hex", "linear", (256, 256), (512, 512)), 2, False),
]


@pytest.mark.parametrize("path,plan,esz,shift", ROUTES,
                         ids=[f"{r[0]}-esz{r[2]}" for r in ROUTES])
def test_route_matches_reference(path, plan, esz, shift):
    """The port takes shift_resample exactly where the reference's TPU
    routing takes its shift kernel, for the image's element size."""
    port, ref = _plans(*plan)
    assert tsamp.takes_shift_route(port, esz) is shift
    assert jrs.shift_prefers(ref, esz) is shift


def test_route_of_the_4k_mosaic_depends_on_the_sample_dtype():
    """render_mosaic samples in bf16, whose source fits the TPU kernel's
    8 MiB; in f32 the same plan would cross it."""
    plan = trender._mosaic_sample_plan(540, 960, 2160, 3840, 0, None)
    assert tsamp.takes_shift_route(plan, 2)
    assert not tsamp.takes_shift_route(plan, 4)


def test_4k_rect_to_hex_leg_runs_plan_gather_on_cpu():
    """apply_plan_auto sends the P-4K leg to plan_gather (its plain version
    here: no launch), as the TPU sends it to its banded kernel."""
    port, _ = _plans("rect", "bilinear", (2160, 3840), (1080, 1920))
    x = torch.rand((1, 3, 2160, 3840), generator=torch.Generator()
                   .manual_seed(0)).to(torch.bfloat16)
    before = counts().get("plan_gather", 0)
    got = tsamp.apply_plan_auto(x, port)
    assert counts().get("plan_gather", 0) == before
    assert torch.equal(got, tsamp.apply_plan(x, port))


@pytest.mark.parametrize("kind,method,src,out", [
    ("rect", "bilinear", (64, 64), (32, 32)),
    ("hex", "linear", (40, 56), (80, 112)),
])   # the K=4 and K=3 families of tests/test_kernels.py:211-216
def test_plan_gather_matches_banded_tier(kind, method, src, out):
    """The banded one-hot kernel (#2, resample_pallas.py:374), forced at
    small shapes in interpret mode, against plan_gather's plain version."""
    port, ref = _plans(kind, method, src, out)
    x = np.random.default_rng(out[0]).random((3,) + src).astype(np.float32)
    want = np.asarray(jrp.apply_plan_pallas(x, ref, force_banded=True))
    got = resample.plan_gather(torch.from_numpy(x), port).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("force_banded", [False, True])
def test_plan_gather_matches_phased_tiers(force_banded):
    """The phase-cached kernels (#3 :289, and banded #4 :315) at a plan
    with few row phases (tests/test_kernels.py:313-328)."""
    port, ref = _plans("rect", "bilinear", (64, 64), (32, 32))
    assert jrp._launch_geometry(ref, 6, 4, force_banded=force_banded
                                ).phase_mode
    x = np.random.default_rng(1).random((2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(jrp.apply_plan_pallas(x, ref,
                                            force_banded=force_banded))
    got = resample.plan_gather(torch.from_numpy(x), port).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
