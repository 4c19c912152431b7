"""The port's ``ops/convert.py`` and ``nn/experimental.py`` against
hygrid_tpu's, on the same numpy inputs, and against the goldens frozen from
the reference archive (``tests/goldens/experimental_goldens.npz``, the keys
``tests/test_experimental.py`` reads).  Also ``hex_conv2d``'s bias dtype.

Float32.  Tolerances: copies and pools exact; one conv, transposed conv or
einsum within 1e-5 absolute (outputs O(1), only summation orders differ);
the goldens within the reference test's own bounds.  The transposed conv's
three executors (canvas, phase, matmul) agree within 2e-5 (the matmul one
sums taps in another order), NCHW and NHWC alike.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.nn import experimental as JE
from hygrid_tpu.nn import functional as JF
from hygrid_tpu.ops import convert as JC
from hygrid_tpu_torch.nn import experimental as TE
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.ops import convert as TC

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "experimental_goldens.npz")
TOL = 1e-5


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, atol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---- ops/convert.py ---------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (6, 7)])
def test_convert_matches_jax_and_round_trips(shape, offset):
    x = np.random.default_rng(len(shape) + offset).random(shape).astype(
        np.float32)
    for fwd, back in (("heximage_to_type1", "type1_to_heximage"),
                      ("heximage_to_type2", "type2_to_heximage")):
        got = getattr(TC, fwd)(_t(x), offset)
        want = getattr(JC, fwd)(x, offset)
        assert torch.equal(got, _t(np.asarray(want)))
        img, off = getattr(TC, back)(got, offset)
        jimg, joff = getattr(JC, back)(np.asarray(want), offset)
        assert off == joff == offset
        assert torch.equal(img, _t(np.asarray(jimg)))
        assert torch.equal(img, _t(x).reshape(img.shape))


def test_convert_numpy_input_goes_to_the_device_asked():
    x = np.ones((1, 1, 2, 3), np.float32)
    assert TC.heximage_to_type1(x, 0, device="cpu").device.type == "cpu"


# ---- the goldens ------------------------------------------------------------

@pytest.mark.parametrize("n,off,s", [(0, 1, 1), (1, 0, 1), (2, 1, 2), (3, 0, 2)])
def test_hex_conv_transpose2d_goldens(g, n, off, s):
    k = _t(g[f"convT{n}_kernel"][:, :, 0, :])
    out = TE.hex_conv_transpose2d(_t(g["x"]), k, even_odd_offset=off,
                                  radius=2, stride=s)
    _close(out, g[f"convT{n}_out"])


@pytest.mark.parametrize("n,u", [(0, 2), (1, 3)])
def test_hex_pixel_shuffle_goldens(g, n, u):
    _close(TE.hex_pixel_shuffle(_t(g[f"ps{n}_x"]), u), g[f"ps{n}_out"], 1e-6)


def test_hex_pixel_shuffle_guards():
    with pytest.raises(ValueError, match="upscale_factor must be >= 2"):
        TE.hex_pixel_shuffle(torch.ones((1, 4, 4, 4)), 1)
    with pytest.raises(ValueError, match="divisible"):
        TE.hex_pixel_shuffle(torch.ones((1, 5, 4, 4)), 2)


@pytest.mark.parametrize("n,off", [(0, 0), (1, 1)])
def test_hex_to_square_double_stride_goldens(g, n, off):
    out = TE.hex_to_square_conv2d_by_double_stride(
        _t(g["x"]), _t(g[f"h2s{n}_kernel"]), even_odd_offset=off)
    _close(out, g[f"h2s{n}_out"], 1e-6)


def test_square_to_hex_double_stride_goldens(g):
    out = TE.square_to_hex_conv2d_by_double_stride(_t(g["s2h_x"]),
                                                   _t(g["s2h_kernel"]))
    _close(out, g["s2h_out"], 1e-6)


def test_hex_to_square_original_resolution_goldens(g):
    out = TE.hex_to_square_original_resolution(_t(g["h2so_x"]),
                                               even_odd_offset=0)
    _close(out, g["h2so_out"], 1e-6)


def test_quadtree_pooling_goldens(g):
    _close(TE.quadtree_hex_pooling(_t(g["quad_x"]), "max", 0), g["quad_out"],
           0)


def test_im2col_hex_conv2d_goldens(g):
    out = TE.im2col_hex_conv2d(_t(g["im2col_x"]), _t(g["im2col_weight"]),
                               even_odd_offset=0, kernel_radius=2)
    _close(out, g["im2col_out"], 1e-6)


# ---- every function against hygrid_tpu --------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("method", ["max", "min", "average"])
@pytest.mark.parametrize("offset", [0, 1])
def test_quadtree_pooling_matches_jax(method, offset):
    x = _rng(offset).random((2, 3, 14, 11)).astype(np.float32)
    want = JE.quadtree_hex_pooling(x, method, offset)
    _close(TE.quadtree_hex_pooling(_t(x), method, offset), want, 1e-6)


@pytest.mark.parametrize("kernelsize,stride,padding,offset",
                         [(2, None, 0, 0), (2, 2, 1, 1), (3, 2, 0, 0),
                          (2, 4, 0, 1)])
def test_diamond_pooling_matches_jax(kernelsize, stride, padding, offset):
    x = _rng(kernelsize).random((1, 2, 16, 13)).astype(np.float32)
    want = JE.diamond_hex_pooling(x, "max", kernelsize, stride, padding,
                                  offset)
    got = TE.diamond_hex_pooling(_t(x), "max", kernelsize, stride, padding,
                                 offset)
    _close(got, want, 0)


@pytest.mark.parametrize("f,padding,offset", [(2, 0, 0), (2, 1, 1), (4, 0, 1)])
def test_hex_to_square_double_stride_matches_jax(f, padding, offset):
    rng = _rng(f + offset)
    x = rng.random((2, 3, 16, 14)).astype(np.float32)
    k = rng.random((3, f, f)).astype(np.float32)
    want = JE.hex_to_square_conv2d_by_double_stride(
        x, k, even_odd_offset=offset, padding=padding)
    got = TE.hex_to_square_conv2d_by_double_stride(
        _t(x), _t(k), even_odd_offset=offset, padding=padding)
    _close(got, want)


@pytest.mark.parametrize("f,padding", [(2, 0), (2, 1), (4, 0)])
def test_square_to_hex_double_stride_matches_jax(f, padding):
    rng = _rng(10 + f)
    x = rng.random((1, 3, 17, 15)).astype(np.float32)
    k = rng.random((3, f * f)).astype(np.float32)
    want = JE.square_to_hex_conv2d_by_double_stride(x, k, padding=padding)
    got = TE.square_to_hex_conv2d_by_double_stride(_t(x), _t(k),
                                                   padding=padding)
    _close(got, want)


@pytest.mark.parametrize("offset,padding", [(0, 0), (1, 0), (0, 1)])
def test_hex_to_square_original_resolution_matches_jax(offset, padding):
    rng = _rng(20 + offset)
    x = rng.random((2, 3, 10, 9)).astype(np.float32)
    k = rng.random((3, 4)).astype(np.float32)
    for kernel in (None, k):
        want = JE.hex_to_square_original_resolution(
            x, kernel, even_odd_offset=offset, padding=padding)
        got = TE.hex_to_square_original_resolution(
            _t(x), None if kernel is None else _t(kernel),
            even_odd_offset=offset, padding=padding)
        _close(got, want)


@pytest.mark.parametrize("radius,stride,padding,offset",
                         [(2, 1, 0, 0), (2, 1, 1, 1), (3, 2, 0, 1),
                          (2, 2, 2, 0)])
def test_im2col_matches_jax(radius, stride, padding, offset):
    rng = _rng(radius * 10 + stride)
    x = rng.random((2, 3, 11, 10)).astype(np.float32)
    kn = JF.hex_kernel_num(radius)
    w = rng.normal(size=(kn * 3, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    _close(TE.hex_im2col(_t(x), offset, radius, stride, padding),
           JE.hex_im2col(x, offset, radius, stride, padding), 0)
    want = JE.im2col_hex_conv2d(x, w, b, even_odd_offset=offset,
                                kernel_radius=radius, stride=stride,
                                padding=padding)
    got = TE.im2col_hex_conv2d(_t(x), _t(w), _t(b), even_odd_offset=offset,
                               kernel_radius=radius, stride=stride,
                               padding=padding)
    _close(got, want)


def test_unfold_helpers_match_jax():
    x = _rng(30).random((1, 2, 13, 17)).astype(np.float32)
    _close(TE.pixel_even_row_quadtree_unfold(_t(x)),
           JE.pixel_even_row_quadtree_unfold(x), 0)
    for d, stride in ((2, None), (2, 1), (3, 2)):
        _close(TE.pixel_even_row_dimond_unfold_1(_t(x), d, stride),
               JE.pixel_even_row_dimond_unfold_1(x, d, stride), 0)
    for d, stride in ((2, None), (4, 2)):
        _close(TE.pixel_even_row_square_unfold(_t(x), d, stride),
               JE.pixel_even_row_square_unfold(x, d, stride), 0)
    with pytest.raises(ValueError, match="must be even"):
        TE.pixel_even_row_square_unfold(_t(x), 3)


def test_weight_initialisers_match_jax():
    for name, args in (("hex_to_square_downsample_weight", (3, 2)),
                       ("hex_to_square_downsample_weight", (2, 4)),
                       ("square_downsample_weight", (2, 4)),
                       ("diamond_weight", (1,)), ("diamond_weight", (3,))):
        got = getattr(TE, name)(*args, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, getattr(JE, name)(*args), 1e-7)


# ---- the transposed conv ----------------------------------------------------

def _tconv_inputs(r, s, off, groups=1, seed=0):
    rng = _rng(r * 10 + s + off + seed)
    kn = JF.hex_kernel_num(r)
    c, o = 4 * groups, 4
    x = rng.normal(size=(2, c, 10, 9)).astype(np.float32)
    k = rng.normal(0, 0.2, (o, c // groups, kn)).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("r", [2, 3])
def test_transpose_executors_agree(r, s, off):
    """canvas, phase and matmul, NCHW and NHWC, within 2e-5 of each other
    (phase bit-equal to canvas, as the reference tests it), and, at offset
    0, of hygrid_tpu's canvas form."""
    x, k, b = _tconv_inputs(r, s, off)
    kw = dict(even_odd_offset=off, radius=r, stride=s)
    want = TE.hex_conv_transpose2d(_t(x), _t(k), _t(b), impl="canvas", **kw)
    if off == 0:
        _close(want, JE._hex_conv_transpose2d_canvas(x, k, b, **kw))
    xl = _t(x).permute(0, 2, 3, 1)
    for impl in ("phase", "matmul", "auto"):
        got = TE.hex_conv_transpose2d(_t(x), _t(k), _t(b), impl=impl, **kw)
        if impl == "phase":
            assert torch.equal(got, want)
        _close(got, want, 2e-5)
        nhwc = TE.hex_conv_transpose2d(xl, _t(k), _t(b), impl=impl,
                                       data_format="NHWC", **kw)
        assert torch.equal(nhwc.permute(0, 3, 1, 2), got)


@pytest.mark.parametrize("impl", ["canvas", "phase", "matmul"])
@pytest.mark.parametrize("groups", [1, 2])
def test_transpose_matches_jax_per_executor(impl, groups):
    x, k, b = _tconv_inputs(2, 2, 0, groups, seed=7)
    kw = dict(even_odd_offset=0, radius=2, stride=2, groups=groups,
              impl=impl)
    want = JE.hex_conv_transpose2d(x, k, b, **kw)
    _close(TE.hex_conv_transpose2d(_t(x), _t(k), _t(b), **kw), want)


def test_transpose_phase_plan_is_the_reference_plan():
    for r, s, off in ((2, 2, 0), (2, 3, 1), (3, 1, 0), (1, 2, 1)):
        assert TE._transpose_phase_plan(r, s, off) == \
            JE._transpose_phase_plan(r, s, off)


def test_transpose_matmul_accumulates_bf16_in_f32():
    """The matmul executor returns float32 for bfloat16 input, the phase
    executor the input's dtype (both as in hygrid_tpu)."""
    x, k, b = _tconv_inputs(2, 2, 0)
    xb, kb = _t(x).bfloat16(), _t(k).bfloat16()
    for impl, dtype in (("matmul", jnp.float32), ("phase", jnp.bfloat16)):
        got = TE.hex_conv_transpose2d(xb, kb, impl=impl, radius=2, stride=2)
        want = JE.hex_conv_transpose2d(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(k, jnp.bfloat16),
                                       impl=impl, radius=2, stride=2)
        assert want.dtype == dtype
        assert got.dtype == (torch.float32 if dtype == jnp.float32
                             else torch.bfloat16)
        _close(got.float(), np.asarray(want, np.float32), 5e-2)


def test_transpose_argument_checks():
    x, k = torch.ones((1, 4, 8, 8)), torch.ones((4, 4, 7))
    with pytest.raises(ValueError, match="unknown impl"):
        TE.hex_conv_transpose2d(x, k, radius=2, stride=2, impl="bogus")
    with pytest.raises(ValueError, match="unknown data_format"):
        TE.hex_conv_transpose2d(x, k, radius=2, stride=2, data_format="NCWH")
    with pytest.raises(ValueError, match="too small"):
        TE.hex_conv_transpose2d(torch.ones((1, 4, 1, 1)), k, radius=3,
                                stride=1, impl="phase")


def test_transpose_upsamples_to_the_hexunet_shapes():
    """A stride-2 radius-2 transposed conv maps HexUNet-small's 64x63 and
    128x127 stages to 127x125 and 255x253 (the shapes hygrid_tpu gives)."""
    k = torch.zeros((1, 1, 7))
    for (h, w), want in (((64, 63), (127, 125)), ((128, 127), (255, 253))):
        out = TE.hex_conv_transpose2d(torch.zeros((1, 1, h, w)), k,
                                      radius=2, stride=2)
        assert tuple(out.shape[-2:]) == want


# ---- hex_conv2d's bias dtype ------------------------------------------------

@pytest.mark.parametrize("impl", ["direct", "pallas", "type1", "auto"])
@pytest.mark.parametrize("xdt,bdt", [("bfloat16", "float32"),
                                     ("float32", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_hex_conv2d_bias_dtype_matches_jax(impl, xdt, bdt):
    """A float32 bias on a bfloat16 conv: hygrid_tpu adds it after the conv
    in the promoted dtype (float32) on every route but the Pallas kernel's,
    which rounds it to the conv's dtype (``conv_pallas.py:205-206``); the
    port returns the same dtype and values.  (2, 8, 12, 11), r=2, padding
    1, bias ~ 100: rounding that bias to bf16 moved values by up to 0.41."""
    rng = _rng(0)
    x = rng.random((2, 8, 12, 11)).astype(np.float32)
    k = rng.normal(0, 0.3, (8, 8, 7)).astype(np.float32)
    b = (100 + rng.normal(0, 1, 8)).astype(np.float32)
    jd, td = getattr(jnp, xdt), getattr(torch, xdt)
    jb, tb = getattr(jnp, bdt), getattr(torch, bdt)
    kw = dict(radius=2, padding=1, impl=impl)
    want = JF.hex_conv2d(jnp.asarray(x, jd), jnp.asarray(k, jd),
                         jnp.asarray(b, jb), **kw)
    got = TF.hex_conv2d(_t(x).to(td), _t(k).to(td), _t(b).to(tb), **kw)
    assert str(got.dtype) == f"torch.{want.dtype}"
    want = np.asarray(want, np.float32)
    if got.dtype == torch.float32 and xdt == "float32":
        _close(got, want, 1e-4)
    else:
        # bf16 conv sums: a few bf16 ulps at |y| <= 130 apart, but the bias
        # itself exact in float32 (the fault moved it by up to 0.41)
        _close(got.float(), want, 1.01)
        assert float((got.float() - _t(want)).abs().mean()) <= 0.1
