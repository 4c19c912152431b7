"""The port's hex filter bank and streaming video path against hygrid_tpu.

Filters: all seven functions within 1e-5 in float32 (the depthwise conv's
summation order only), at radius 1-4 and input offset 0/1; plus ports of
hygrid_tpu's own filter tests.  Video processors: within 1e-5 in float32
compute, and in bfloat16 within one bf16 ulp at the output's largest
magnitude (hygrid_tpu blends bf16 in bf16 with bf16 weights, the port in
float32 with one rounding); stream order and counts, microbatches equal to
per-frame results, ``post``.  The 24x1280 frames take the shift resampler
(hex width 640), the 72x128 ones plan_gather.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hygrid_tpu.models import video as jvideo
from hygrid_tpu.nn import filters as jfilters

from hygrid_tpu_torch.models import HexCNN, hexcnn_small, hexcnn_tiny
from hygrid_tpu_torch.models import video as tvideo
from hygrid_tpu_torch.nn import HexConvStack
from hygrid_tpu_torch.nn import filters
from hygrid_tpu_torch.nn import functional as F
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.ops.geometry import rect_to_hex_resample
from hygrid_tpu_torch.viz import render_mosaic

TOL = 1e-5
TAPS = {1: 1, 2: 7, 3: 19, 4: 37}


@pytest.mark.parametrize("name,args", [
    ("hex_gaussian_kernel", (0.8,)), ("hex_gaussian_kernel", ()),
    ("hex_laplacian_kernel", ()), ("hex_sharpen_kernel", (0.5,)),
    ("hex_mean_kernel", ())])
def test_tap_builders_bit_equal(name, args):
    got = getattr(filters, name)(*args)
    want = getattr(jfilters, name)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_hex_filter_matches_jax(radius, offset):
    rng = np.random.default_rng(10 * radius + offset)
    x = rng.random((2, 3, 13, 12)).astype(np.float32)
    taps = rng.normal(0, 0.3, TAPS[radius]).astype(np.float32)
    want = np.asarray(jfilters.hex_filter(x, taps, even_odd_offset=offset))
    got = filters.hex_filter(torch.from_numpy(x), taps,
                             even_odd_offset=offset)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fn", ["hex_gaussian_blur", "hex_edge_detect"])
def test_blur_and_edges_match_jax(fn, offset):
    x = np.random.default_rng(offset).random((1, 2, 11, 14)).astype(
        np.float32)
    want = np.asarray(getattr(jfilters, fn)(x, even_odd_offset=offset))
    got = getattr(filters, fn)(torch.from_numpy(x), even_odd_offset=offset)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_integer_input_filters_in_float32():
    x = np.random.default_rng(2).integers(0, 255, (3, 10, 9)).astype(
        np.uint8)
    taps = filters.hex_gaussian_kernel()
    want = np.asarray(jfilters.hex_filter(x, taps))
    got = filters.hex_filter(torch.from_numpy(x), taps)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


class TestFilters:
    """hygrid_tpu's tests/test_filters_video.py::TestFilters, on the port."""

    def test_gaussian_preserves_constant(self):
        x = torch.full((1, 3, 12, 10), 5.0)
        out = filters.hex_gaussian_blur(x).numpy()
        np.testing.assert_allclose(out[:, :, 2:-2, 2:-2], 5.0, atol=1e-5)

    def test_laplacian_zero_on_constant(self):
        x = torch.full((1, 1, 12, 10), 3.0)
        out = filters.hex_edge_detect(x).numpy()
        np.testing.assert_allclose(out[:, :, 2:-2, 2:-2], 0.0, atol=1e-5)

    def test_laplacian_responds_to_edges(self):
        x = np.zeros((1, 1, 16, 16), np.float32)
        x[:, :, :, 8:] = 1.0
        out = filters.hex_edge_detect(x).numpy()
        assert np.abs(out[0, 0, 8, 6:10]).max() > 0.1
        np.testing.assert_allclose(out[0, 0, 8, 2:5], 0.0, atol=1e-5)

    def test_sharpen_identity_plus_edges(self):
        x = np.random.default_rng(0).random((1, 2, 12, 12)).astype(
            np.float32)
        s = filters.hex_filter(x, filters.hex_sharpen_kernel(0.0)).numpy()
        np.testing.assert_allclose(s[:, :, 2:-2, 2:-2], x[:, :, 2:-2, 2:-2],
                                   atol=1e-5)

    def test_filter_matches_explicit_conv(self):
        x = np.random.default_rng(1).random((2, 3, 10, 11)).astype(
            np.float32)
        taps = filters.hex_gaussian_kernel(0.8)
        got = filters.hex_filter(x, taps).numpy()
        kernel = torch.from_numpy(np.broadcast_to(taps, (3, 1, 7)).copy())
        want = F.hex_conv2d(torch.from_numpy(x), kernel, even_odd_offset=0,
                            radius=2, padding=1, groups=3,
                            impl="type1").numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_bad_tap_count(self):
        with pytest.raises(ValueError):
            filters.hex_filter(np.ones((1, 1, 8, 8)), np.ones(5))


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((3, h, w)).astype(np.float32) for _ in range(n)]


def _bf16_ulp_at(v: np.ndarray) -> float:
    """Spacing of bfloat16 numbers at max |v|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(v).max())) - 7))


@pytest.mark.parametrize("size", [(72, 128), (24, 1280)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_processor_matches_jax(size, dtype):
    h, w = size
    x = _frames(1, h, w, seed=h)[0]
    want = np.asarray(jvideo.make_frame_processor(
        h, w, compute_dtype=getattr(jnp, dtype))(jnp.asarray(x))
        .astype(jnp.float32))
    proc = tvideo.make_frame_processor(
        h, w, compute_dtype=getattr(torch, dtype), device="cpu")
    got = proc(x)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape == (3, h // 2, w // 2)
    atol = TOL if dtype == "float32" else _bf16_ulp_at(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_processor_matches_jax(dtype):
    x = np.stack(_frames(2, 24, 1280, seed=3))
    want = np.asarray(jvideo.make_batch_processor(
        24, 1280, compute_dtype=getattr(jnp, dtype))(jnp.asarray(x))
        .astype(jnp.float32))
    got = tvideo.make_batch_processor(
        24, 1280, compute_dtype=getattr(torch, dtype), device="cpu")(x)
    atol = TOL if dtype == "float32" else _bf16_ulp_at(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_keeps_order_and_counts(depth):
    frames = _frames(7, 24, 1280, seed=4)
    proc = tvideo.make_frame_processor(24, 1280, device="cpu")
    stats = tvideo.StreamStats()
    outs = list(tvideo.process_stream(iter(frames), proc, stats,
                                      depth=depth))
    assert stats.frames == 7 and stats.seconds > 0 and stats.fps > 0
    assert len(outs) == 7
    for frame, out in zip(frames, outs):
        assert torch.equal(out, proc(frame))


@pytest.mark.parametrize("microbatch", [2, 3])
def test_microbatch_equals_per_frame(microbatch):
    frames = _frames(7, 24, 1280, seed=5)
    single = tvideo.make_frame_processor(24, 1280, device="cpu")
    batch = tvideo.make_batch_processor(24, 1280, device="cpu")
    stats = tvideo.StreamStats()
    outs = list(tvideo.process_stream(iter(frames), batch, stats,
                                      microbatch=microbatch))
    assert stats.frames == 7 and len(outs) == 7
    for frame, out in zip(frames, outs):
        want = single(frame)
        assert bool(((out.float() - want.float()).abs()
                     <= _bf16_ulp_at(want.float().numpy())).all())


def test_post_runs_a_port_model():
    model = hexcnn_tiny(norm="GN", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    proc = tvideo.make_frame_processor(32, 32, compute_dtype=torch.float32,
                                       post=model, device="cpu")
    x = _frames(1, 32, 32, seed=6)[0]
    with torch.no_grad():
        logits = proc(x)
        hexed = rect_to_hex_resample(torch.from_numpy(x)[None], (16, 16),
                                     "bilinear")
        want = model(filters.hex_gaussian_blur(hexed))[0]
    assert tuple(logits.shape) == (10,)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-6)


class TestVideo:
    """hygrid_tpu's tests/test_filters_video.py::TestVideo and
    ::TestVideoMicrobatch, on the port."""

    def test_stream_processes_all_frames(self):
        proc = tvideo.make_frame_processor(32, 48, device="cpu")
        stats = tvideo.StreamStats()
        outs = list(tvideo.process_stream(iter(_frames(5, 32, 48)), proc,
                                          stats))
        assert len(outs) == 5 and stats.frames == 5
        assert all(tuple(o.shape) == (3, 16, 24) for o in outs)

    def test_processor_with_post(self):
        proc = tvideo.make_frame_processor(
            32, 32, post=lambda h: h.mean(dim=(2, 3)), device="cpu")
        assert tuple(proc(torch.ones((3, 32, 32))).shape) == (3,)

    def test_microbatch_stream(self):
        frames = _frames(7, 16, 16, seed=1)
        proc = tvideo.make_batch_processor(16, 16, device="cpu")
        stats = tvideo.StreamStats()
        outs = list(tvideo.process_stream(iter(frames), proc, stats,
                                          microbatch=3))
        assert len(outs) == 7 and stats.frames == 7
        single = tvideo.make_frame_processor(16, 16, device="cpu")
        np.testing.assert_allclose(outs[0].float().numpy(),
                                   single(frames[0]).float().numpy(),
                                   atol=1e-5)


ENTRY_POINTS = [HexCNN, hexcnn_small, hexcnn_tiny, HexConvStack,
                tvideo.make_frame_processor, tvideo.make_batch_processor,
                render_mosaic, tgeo.rect_to_hex_resample,
                tgeo.hex_to_rect_resample, tgeo.hexresize,
                tgeo.image_geometric_transformation]


@pytest.mark.parametrize("entry", ENTRY_POINTS,
                         ids=[e.__name__ for e in ENTRY_POINTS])
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU (the factories pass ``device`` on to ``HexCNN``)."""
    fn = HexCNN if entry in (hexcnn_small, hexcnn_tiny) else entry
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if entry is hexcnn_small and not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            hexcnn_small(norm="GN")
