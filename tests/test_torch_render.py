"""The port's hexagon-mosaic renderer against hygrid_tpu.

``mosaic_plan`` is a numpy copy and bit-equal.  ``render_mosaic`` is an
exact-select plan: float32 frames sampled in bfloat16 and uint8 frames
come out bit-equal to the reference's, and so does ``background``.  The
136x240 -> 544x960 render takes the shift resampler (den = 4, 960 columns),
the small ones plan_gather.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hygrid_tpu.viz import render as jrender

from hygrid_tpu_torch.kernels import resample_shift
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.ops import sampling
from hygrid_tpu_torch.viz import ViewState, mosaic_plan, render_mosaic
from hygrid_tpu_torch.viz import render as trender

VIEWS = [None, ViewState(hierarchy=1), ViewState(dx=0.05, dy=-0.1),
         ViewState(scale=1.7).pan(0.02, 0.03), ViewState().zoom(0.6).coarser(2)]


def _ref_view(view):
    return None if view is None else jrender.ViewState(
        view.dx, view.dy, view.scale, view.hierarchy)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("view", VIEWS, ids=[str(v) for v in VIEWS])
def test_mosaic_plan_bit_equal(view, offset):
    got = mosaic_plan(13, 17, 61, 83, offset, view)
    want = jrender.mosaic_plan(13, 17, 61, 83, offset, _ref_view(view))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_view_state_helpers():
    v = ViewState().pan(0.1, -0.2).zoom(2.0).coarser()
    assert (v.dx, v.dy, v.scale, v.hierarchy) == (0.1, -0.2, 2.0, 1)


@pytest.mark.parametrize("size", [(12, 10, 64, 72), (136, 240, 544, 960)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_render_matches_jax(size, dtype):
    h, w, oh, ow = size
    rng = np.random.default_rng(h)
    img = (rng.random((3, h, w)) * 255).astype(dtype)
    want = np.asarray(jrender.render_mosaic(img, (oh, ow)))
    got = render_mosaic(img, (oh, ow), device="cpu")
    assert str(got.dtype) == f"torch.{dtype}"
    assert np.array_equal(got.numpy(), want)
    plan = trender._mosaic_sample_plan(h, w, oh, ow, 0, None)
    assert sampling.takes_shift_route(plan, 2) is (ow >= 640)


def test_render_shift_route_counts_no_launch_on_cpu():
    """On the CPU the wrapper runs its plain version: no kernel launch."""
    before = counts().get("shift_resample", 0)
    render_mosaic(np.ones((3, 136, 240), np.float32), (544, 960),
                  device="cpu")
    assert counts().get("shift_resample", 0) == before


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_render_background_matches_jax(dtype):
    img = (np.random.default_rng(2).random((2, 9, 11)) * 200).astype(dtype)
    view = ViewState(scale=0.7)
    want = np.asarray(jrender.render_mosaic(img, (50, 60), view=_ref_view(
        view), background=37.0))
    got = render_mosaic(torch.from_numpy(img), (50, 60), view=view,
                        background=37.0)
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() == 37).any()


def test_render_2d_input_and_offset():
    img = np.random.default_rng(3).random((9, 11)).astype(np.float32)
    want = np.asarray(jrender.render_mosaic(jnp.asarray(img), (40, 40), 1))
    got = render_mosaic(img, (40, 40), 1, device="cpu")
    assert tuple(got.shape) == (1, 40, 40)
    assert np.array_equal(got.numpy(), want)


def test_view_cache_bounds_plans_and_their_geometry():
    """The view cache is the one cap: each view's shift geometry lives on
    its plan, and an evicted view is built anew."""
    trender._PLAN_CACHE.clear()
    views = [ViewState(dx=0.01 * i) for i in range(trender._PLAN_CACHE_MAX
                                                    + 2)]
    plans = [trender._mosaic_sample_plan(8, 8, 64, 64, 0, v) for v in views]
    assert len(trender._PLAN_CACHE) == trender._PLAN_CACHE_MAX
    geo = resample_shift.shift_decompose_cached(plans[-1])
    assert plans[-1]._derived["shift"] is geo
    assert trender._mosaic_sample_plan(8, 8, 64, 64, 0, views[-1]) is plans[-1]
    assert trender._mosaic_sample_plan(8, 8, 64, 64, 0, views[0]) \
        is not plans[0]


class TestViewer:
    """hygrid_tpu's tests/test_image_viz.py::TestViewer (the mosaic part),
    on the port."""

    def test_constant_image_renders_constant_interior(self):
        img = np.full((3, 8, 8), 7.0, np.float32)
        frame = render_mosaic(img, (64, 64), device="cpu").numpy()
        assert set(np.unique(frame[:, 8:-8, 8:-8])) == {7.0}

    def test_every_hex_cell_painted(self):
        h, w = 6, 5
        img = np.arange(h * w, dtype=np.float32).reshape(1, h, w)
        frame = render_mosaic(img, (h * 8, w * 8), device="cpu").numpy()
        assert set(range(h * w)) <= set(np.unique(frame).astype(int))

    def test_hierarchy_changes_mosaic_pitch(self):
        img = np.arange(64, dtype=np.float32).reshape(1, 8, 8)
        fine = render_mosaic(img, (64, 64), device="cpu").numpy()
        lvl1 = render_mosaic(img, (64, 64), view=ViewState(hierarchy=1),
                             device="cpu").numpy()
        assert not np.array_equal(fine, lvl1)
        assert set(np.unique(lvl1)) <= set(range(64)) | {0.0}

    def test_integer_mosaic_bit_exact(self):
        img = np.random.default_rng(11).integers(0, 256, (3, 8, 8),
                                                 dtype=np.uint8)
        frame = render_mosaic(img, (64, 64), device="cpu").numpy()
        assert frame.dtype == np.uint8
        assert set(np.unique(frame)) <= set(np.unique(img)) | {0}

    def test_mosaic_plan_is_exact_select(self):
        flat, mask = mosaic_plan(8, 8, 64, 64)
        assert flat.shape == (64, 64) and mask.shape == (64, 64)
        assert set(np.unique(mask)) <= {0.0, 1.0}
        plan = trender._mosaic_sample_plan(8, 8, 64, 64, 0, None)
        assert plan.exact_select and plan.idx.shape == (1, 64, 64)
