"""The single-op hex conv (``hygrid_tpu_torch.kernels.conv_single``, the
counterpart of TPU kernels #7 ``_conv_kernel`` and #8 ``_conv_kernel_banded``)
against ``hygrid_tpu``: ``hex_conv2d(impl="pallas")`` on both sides, the JAX
Pallas kernels in interpret mode on the CPU (as ``tests/test_kernels.py``
runs them; the other JAX functions under ``jax.jit``), the port's wrapper
on its plain version.  Float32; outputs
and grads within 1e-5 absolute (weights scaled so outputs are O(1); only
summation orders differ).  The kernel's tap table is held to the direct
conv by a numpy gather, the computation the CUDA kernel runs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as JP
from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch.kernels import conv_single
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.nn import layers as TL

TOL = 1e-5

# (B, C, Cout, H, W, radius, padding, dilation, offset, bias): C in
# {16, 32, 128}, both parities, padding 0/1/2, dilation 1/2, radius 2/3
CASES = [
    (2, 16, 24, 11, 13, 2, 1, 1, 0, True),
    (1, 32, 32, 12, 10, 2, 0, 1, 1, False),
    (1, 128, 64, 9, 8, 2, 1, 1, 1, True),
    (1, 32, 16, 15, 14, 2, 2, 2, 1, True),
    (1, 16, 32, 13, 11, 3, 0, 2, 0, False),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _inputs(case):
    b, c, co, h, w, r, p, d, off, has_bias = case
    rng = np.random.default_rng(sum(case))
    kn = TF.hex_kernel_num(r)
    x = rng.random((b, c, h, w)).astype(np.float32)
    k = (rng.normal(0, 1, (co, c, kn)) / np.sqrt(c * kn)).astype(np.float32)
    bias = rng.normal(0, 1, co).astype(np.float32) if has_bias else None
    kw = dict(even_odd_offset=off, radius=r, padding=p, dilation=d)
    return x, k, bias, kw


@pytest.mark.parametrize("case", CASES, ids=[
    "C{1}-{2}_r{5}_p{6}_d{7}_off{8}_bias{9}".format(*c) for c in CASES])
def test_hex_conv2d_pallas_matches_jax(case):
    b, c, co, h, w, r, p, d, off, _ = case
    x, k, bias, kw = _inputs(case)
    assert conv_single.takes_single_route(c, co, 1, 1, h + 2 * p, r, d)
    assert JP.pallas_conv_applicable(c, co, 1, 1)
    want = np.asarray(JF.hex_conv2d(x, k, bias, impl="pallas", **kw))
    got = TF.hex_conv2d(_t(x), _t(k), None if bias is None else _t(bias),
                        impl="pallas", **kw)
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[-2:]) == TF.hex_conv2d_output_shape(
        h, w, r, 1, p, d)
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_band_rows_matches_jax_banded_kernel():
    """``band_rows=4`` against the reference's banded kernel (#8), with a
    band that does not divide the output rows."""
    x, k, bias, kw = _inputs(CASES[0])
    want = np.asarray(JP.packed_hex_conv_pallas(x, k, bias, band_rows=4,
                                                **kw))
    got = conv_single.hex_conv_single(_t(x), _t(k), _t(bias), band_rows=4,
                                      **kw)
    assert float(np.abs(got.numpy() - want).max()) <= TOL
    assert torch.equal(got, conv_single.hex_conv_single(_t(x), _t(k),
                                                        _t(bias), **kw))
    with pytest.raises(ValueError, match="band_rows"):
        conv_single.hex_conv_single(_t(x), _t(k), band_rows=0, **kw)


# (C, Cout, stride, groups, H): off the envelope, hex_conv2d(impl="pallas")
# runs the reference's XLA packed conv and the port's direct conv
OFF_ENVELOPE = [(3, 16, 1, 1, 12), (5, 8, 1, 1, 11), (16, 16, 2, 1, 13),
                (16, 16, 1, 2, 12), (16, 16, 1, 1, 2)]


@pytest.mark.parametrize("c,co,stride,groups,h", OFF_ENVELOPE)
def test_off_envelope_matches_jax_fallback(c, co, stride, groups, h):
    rng = np.random.default_rng(c * co + stride + groups)
    x = rng.random((2, c, h, 10)).astype(np.float32)
    k = (rng.normal(0, 1, (co, c // groups, 7)) / np.sqrt(7 * c)
         ).astype(np.float32)
    kw = dict(even_odd_offset=1, radius=2, padding=1, stride=stride,
              groups=groups)
    assert not conv_single.takes_single_route(c, co, stride, groups, h + 2,
                                              2, 1)
    want = np.asarray(jax.jit(functools.partial(
        JF.hex_conv2d, impl="pallas", **kw))(x, k))
    before = counts().get("hex_conv_single", 0)
    got = TF.hex_conv2d(_t(x), _t(k), impl="pallas", **kw)
    assert counts().get("hex_conv_single", 0) == before
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= TOL


def test_pallas_grads_match_jax_vjp():
    """dx, dW and db of ``hex_conv2d(impl="pallas")`` against ``jax.vjp``
    (the reference's custom VJP pulls back through its XLA packed conv);
    relative to each grad's largest entry, as db sums the cotangent over
    every pixel."""
    x, k, bias, kw = _inputs((1, 16, 16, 8, 8, 2, 1, 1, 1, True))
    g = np.random.default_rng(7).normal(size=np.asarray(
        JF.hex_conv2d(x, k, bias, impl="direct", **kw)).shape
    ).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, kk, bb: JF.hex_conv2d(
        xx, kk, bb, impl="pallas", **kw), jnp.asarray(x), jnp.asarray(k),
        jnp.asarray(bias))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    leaves = [_t(v).requires_grad_() for v in (x, k, bias)]
    out = TF.hex_conv2d(*leaves, impl="pallas", **kw)
    got = torch.autograd.grad(out, leaves, _t(g))
    for name, a, b in zip(("dx", "dW", "db"), got, want):
        assert tuple(a.shape) == b.shape, name
        assert float(np.abs(a.numpy() - b).max()) <= TOL * np.abs(b).max(), \
            name


@pytest.mark.parametrize("radius,dilation,parity", [
    (2, 1, 0), (2, 1, 1), (3, 1, 0), (2, 2, 1), (3, 2, 0), (4, 1, 1)])
def test_valid_tap_table_reproduces_direct(radius, dilation, parity):
    """The kernel's computation on the CPU: output pixel (o, j) sums
    ``W_t x(o + T[o&1, t, 0], j + T[o&1, t, 1])`` over taps, zero past the
    last column.  Equal to the reference's direct conv."""
    rng = np.random.default_rng(radius * 10 + dilation + parity)
    b, c, co, h, w = 2, 3, 4, 16, 13
    kn = TF.hex_kernel_num(radius)
    x = rng.random((b, c, h, w)).astype(np.float32)
    k = rng.normal(0, 0.3, (co, c, kn)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        JF.hex_conv2d, even_odd_offset=parity, radius=radius,
        dilation=dilation))(x, k))
    table = TF.hex_valid_tap_table(radius, dilation, parity)
    ho, wo = TF.hex_conv2d_output_shape(h, w, radius, 1, 0, dilation)
    assert want.shape[-2:] == (ho, wo)
    xz = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, wo + table[..., 1].max())))
    got = np.zeros((b, co, ho, wo), np.float64)
    for o in range(ho):
        for t in range(kn):
            dr, dc = table[o & 1, t]
            got[:, :, o] += np.einsum("oc,bcj->boj", k[:, :, t],
                                      xz[:, :, o + dr, dc:dc + wo])
    assert table[..., 0].min() == 0 and table[..., 1].min() >= 0
    np.testing.assert_allclose(got, want, atol=TOL)


def test_same_tap_table_is_the_shifted_valid_one():
    for r, d in [(2, 1), (3, 1), (2, 2), (3, 2)]:
        p = d * (r - 1)
        np.testing.assert_array_equal(
            TF.hex_tap_table(r, d), TF.hex_valid_tap_table(r, d, p % 2) - p)


def test_envelope_copies_the_reference():
    for c in (1, 2, 3, 4, 8, 16, 24, 32, 64, 96, 128, 256):
        for co in (8, 16, 32, 64, 128, 256, 512):
            for stride, groups in ((1, 1), (2, 1), (1, 2)):
                assert conv_single.pallas_conv_applicable(
                    c, co, stride, groups) == JP.pallas_conv_applicable(
                        c, co, stride, groups)


def test_plain_version_equals_the_cpu_wrapper_and_rounds_bf16():
    x, k, bias, kw = _inputs(CASES[1])
    got = conv_single.hex_conv_single(_t(x), _t(k), **kw)
    assert torch.equal(got, conv_single.hex_conv_single_plain(_t(x), _t(k),
                                                              **kw))
    bf = conv_single.hex_conv_single_plain(_t(x), _t(k).bfloat16(), **kw)
    assert bf.dtype == torch.bfloat16
    assert float((bf.float() - got).abs().max()
                 / got.abs().max()) <= 1e-2


def test_numpy_input_follows_the_kernel_device():
    """A tensor stays on its device; numpy input goes to the kernel's
    device, or to the card when neither is a tensor."""
    x, k, bias, kw = _inputs(CASES[0])
    want = TF.hex_conv2d(_t(x), _t(k), _t(bias), impl="direct", **kw)
    got = TF.hex_conv2d(x, _t(k), bias, impl="direct", **kw)
    assert got.device.type == "cpu" and torch.equal(got, want)
    if torch.cuda.is_available():
        assert TF.hex_conv2d(x, k, impl="direct", **kw).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TF.hex_conv2d(x, k, impl="direct", **kw)


@pytest.mark.parametrize("pool,args", [
    ("hex_pool2d", ("max", 2, 2)), ("hex_adaptive_pool2d", ((3, 2), "max")),
    ("hex_global_pool2d", ("average",))])
def test_pool_array_input_goes_to_the_device_asked_for(pool, args):
    """A numpy array lands on ``device`` (the card by default, as
    hygrid_tpu puts it on JAX's default device), in the functions and in
    the pool classes; a tensor stays where it is."""
    x = np.random.default_rng(4).random((2, 3, 9, 8)).astype(np.float32)
    fn = getattr(TF, pool)
    got = fn(x, *args, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, fn(_t(x), *args))
    cls = {"hex_pool2d": TL.HexPool2d, "hex_adaptive_pool2d":
           TL.HexAdaptivePool2d, "hex_global_pool2d": TL.HexGlobalPool2d}[pool]
    assert torch.equal(cls(*args)(_t(x)), got)
    if torch.cuda.is_available():
        assert fn(x, *args).device.type == "cuda"
        assert cls(*args)(x).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fn(x, *args)
        with pytest.raises((RuntimeError, AssertionError)):
            cls(*args)(x)


def test_single_conv_array_input_follows_the_kernel():
    """hex_conv_single: numpy input follows a tensor kernel's device, or
    goes to the card when neither is a tensor."""
    x, k, bias, kw = _inputs(CASES[0])
    want = conv_single.hex_conv_single(_t(x), _t(k), _t(bias), **kw)
    got = conv_single.hex_conv_single(x, _t(k), bias, **kw)
    assert got.device.type == "cpu" and torch.equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            conv_single.hex_conv_single(x, k, **kw)


@pytest.mark.parametrize("stride,offset", [(1, 0), (2, 1)])
def test_adaptive_padding_conv_matches_jax(stride, offset):
    rng = np.random.default_rng(stride + offset)
    x = rng.random((2, 4, 11, 9)).astype(np.float32)
    k = rng.normal(0, 0.3, (6, 4, 7)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        JF.hex_conv2d_adaptive_padding, even_odd_offset=offset, radius=2,
        stride=stride))(x, k, bias))
    got = TF.hex_conv2d_adaptive_padding(
        _t(x), _t(k), _t(bias), even_odd_offset=offset, radius=2,
        stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("outsize,method", [(3, "max"), ((4, 3), "average"),
                                            ((2, 5), "min"), (5, "max")])
def test_adaptive_pool_matches_jax(outsize, method):
    x = np.random.default_rng(3).random((2, 3, 13, 11)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        JF.hex_adaptive_pool2d, outsize=outsize, method=method))(x))
    got = TF.hex_adaptive_pool2d(_t(x), outsize, method)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
