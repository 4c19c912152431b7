"""The affine layer's backward on the CPU (TPU kernel #12 on
``("affine", scale, shift)`` layers, and 12s on the affine split layer):
grads of ``hex_conv_stack(norms=[("affine", ...)])`` in x, the kernels, the
biases, the scales and the shifts against ``jax.grad`` of
``hygrid_tpu``'s ``hex_conv_stack_pallas``, on its interpreted Pallas hand
path (``_stack_bwd_pallas``, asserted as taken) and on its XLA twin
(``HYGRID_STACK_BWD=xla``).

Float32, b=2, 12x11, radius 2, two layers; relative max-abs error <= 1e-4
(summation order, the ReLU mask at the same pre-activations).  The tail's
pullback is ``affine_relu_backward`` (plain torch ops, the counterpart of
the reference's XLA ``jax.vjp`` of ``_make_post``), which is also held to
autograd of ``_post_plain`` here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.nn.functional import hex_kernel_num

REL = 1e-4


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(params=["pallas", "xla"])
def path(request, monkeypatch):
    """The reference's pullback: its hand-written Pallas backward
    (interpreted) or its XLA twin; yields the count of hand-path runs."""
    if request.param == "xla":
        monkeypatch.setenv("HYGRID_STACK_BWD", "xla")
    taken = []
    orig = jcp._stack_bwd_pallas

    def spy(statics, res, g):
        out = orig(statics, res, g)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(jcp, "_stack_bwd_pallas", spy)
    yield request.param, taken


def _case(seed, cins, cout, split):
    """Inputs (x, and the extra input when split), two layers' kernels,
    biases, scales and shifts, and an output cotangent."""
    rng = np.random.default_rng(seed)
    kn = hex_kernel_num(2)
    xs = [rng.random((2, 12, 11, c)).astype(np.float32) for c in cins]
    ks = [rng.normal(0, 1 / np.sqrt(kn * c), (cout, c, kn)).astype(np.float32)
          for c in (sum(cins), cout)]
    bs = [rng.normal(0, 0.1, cout).astype(np.float32) for _ in ks]
    scales = [(1 + 0.3 * rng.normal(size=cout)).astype(np.float32)
              for _ in ks]
    shifts = [rng.normal(0, 0.2, cout).astype(np.float32) for _ in ks]
    cot = rng.normal(size=(2, 12, 11, cout)).astype(np.float32)
    return xs, ks, bs, scales, shifts, cot


def _jax_grads(xs, ks, bs, scales, shifts, cot):
    def loss(xs, ks, bs, scales, shifts):
        out = jcp.hex_conv_stack_pallas(
            xs[0], ks, bs, radius=2, data_format="NHWC",
            norms=[("affine", s, t) for s, t in zip(scales, shifts)],
            extra_input=xs[1] if len(xs) > 1 else None)
        return jnp.sum(out * cot)

    return jax.grad(loss, argnums=tuple(range(5)))(xs, ks, bs, scales,
                                                   shifts)


def _port_grads(xs, ks, bs, scales, shifts, cot):
    leaves = [[_t(v).requires_grad_() for v in group]
              for group in (xs, ks, bs, scales, shifts)]
    txs, tks, tbs, tsc, tsh = leaves
    out = tcs.hex_conv_stack(
        txs[0], tks, tbs, radius=2, data_format="NHWC",
        norms=[("affine", s, t) for s, t in zip(tsc, tsh)],
        extra_input=txs[1] if len(txs) > 1 else None)
    (out * _t(cot)).sum().backward()
    return [[v.grad for v in group] for group in leaves]


@pytest.mark.parametrize("split", [False, True], ids=["layers", "split"])
def test_affine_grads_match_jax(split, path):
    """Two affine layers (16 -> 16 -> 16), or an affine split layer (8 + 8
    -> 8, the hand path's Ca = Cb = Cout) and an affine layer: every grad
    against the reference's."""
    cins, cout = ((8, 8), 8) if split else ((16,), 16)
    case = _case(3 + split, cins, cout, split)
    want = _jax_grads(*case)
    got = _port_grads(*case)
    names = ["x", "kernels", "biases", "scales", "shifts"]
    for name, g_group, w_group in zip(names, got, want):
        for i, (g, w) in enumerate(zip(g_group, w_group)):
            assert g is not None and _rel(g, w) <= REL, (name, i)
    mode, taken = path
    assert taken == ([True] if mode == "pallas" else [])


@pytest.mark.parametrize("relu", [True, False])
def test_affine_relu_backward_is_autograd_of_the_tail(relu):
    """``affine_relu_backward`` against torch autograd of the plain tail
    (``_post_plain``) at the same float32 pre-activation: 1e-6 relative."""
    rng = np.random.default_rng(5)
    y = _t(rng.normal(size=(2, 5, 7, 6))).requires_grad_()
    scale = _t(1 + 0.3 * rng.normal(size=6)).requires_grad_()
    shift = _t(rng.normal(0, 0.3, 6)).requires_grad_()
    gout = _t(rng.normal(size=(2, 5, 7, 6)))
    out = tcs._post_plain(y, ("affine", scale, shift), relu, torch.float32)
    want = torch.autograd.grad(out, (y, scale, shift), gout)
    gpre, dscale, dshift, dbias = tcs.affine_relu_backward(
        y.detach(), scale.detach(), gout, out.detach() if relu else None)
    for got, w in zip((gpre, dscale, dshift), want):
        assert _rel(got, w) <= 1e-6
    assert _rel(dbias, gpre.sum((0, 1, 2))) <= 1e-6
