"""The GN/ReLU tail's backward on the CPU: the closed-form vjp the port's
kernel computes (``csrc/gn_backward.cu``), in its plain version
``gn_relu_backward_plain`` at ``gn_stats_plain``'s statistics, against the
reference and against torch autograd; and the GN layers' grads, which now
pull back through it, against ``jax.grad`` of the JAX stack.

Every input is drawn from a seed with numpy.  Tolerance: 1e-5, the max-abs
error relative to the largest magnitude of the reference, in float32 (the
two sides sum in other orders, and the reference's variance is
``jnp.var`` where the port's is ``E[y^2] - mean^2``).  W is odd throughout;
the constant group (one sample's first group, 0.5 everywhere) drives the
variance to the clamp at 0, where the reference's value is the oracle.  Its
sums are exact, so both sides find the mean exactly and the group's
normalised values are 0: at a constant whose sums round, they are the
mean's rounding times rsqrt(eps), which no two summation orders share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.nn.functional import hex_kernel_num

TOL = 1e-5
CASES = [(g, relu, const) for g in (1, 4, 8) for relu in (True, False)
         for const in (False, True)]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _tail_inputs(seed, groups, const, b=2, h=5, w=7, c=16):
    """NHWC pre-activation y, gamma, beta and an output cotangent."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.2, 1.5, (b, h, w, c)).astype(np.float32)
    if const:
        y[1, ..., :c // groups] = 0.5
    gamma = (1 + 0.2 * rng.normal(size=c)).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    gout = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return y, gamma, beta, gout


def _plain(y, gamma, beta, gout, groups, relu):
    t = [torch.from_numpy(v) for v in (y, gamma, beta, gout)]
    mean, rstd = tcs.gn_stats_plain(t[0], groups)
    return tcs.gn_relu_backward_plain(t[0], mean, rstd, t[1], t[2], t[3],
                                      groups, relu)


@pytest.mark.parametrize("groups,relu,const", CASES)
def test_gn_relu_backward_plain_matches_jax_vjp(groups, relu, const):
    """Against jax.vjp of the reference's GroupNorm
    (conv_pallas._group_norm_nchw) then jax.nn.relu, float32 on the CPU:
    dy, dgamma, dbeta, and dbias (the sum of dy over samples and pixels)."""
    y, gamma, beta, gout = _tail_inputs(groups, groups, const)

    def tail(y, gamma, beta):
        out = jcp._group_norm_nchw(jnp.moveaxis(y, -1, 1), groups, gamma,
                                   beta)
        return jax.nn.relu(out) if relu else out

    _, pull = jax.vjp(tail, y, gamma, beta)
    dy, dgamma, dbeta = pull(jnp.moveaxis(jnp.asarray(gout), -1, 1))
    gpre, g_gamma, g_beta, g_bias = _plain(y, gamma, beta, gout, groups,
                                           relu)
    assert _rel(gpre, dy) <= TOL
    assert _rel(g_gamma, dgamma) <= TOL
    assert _rel(g_beta, dbeta) <= TOL
    assert _rel(g_bias, np.asarray(dy).sum((0, 1, 2))) <= TOL


@pytest.mark.parametrize("groups,relu,const", CASES)
def test_gn_relu_backward_plain_matches_torch_autograd(groups, relu, const):
    """Against torch autograd of the plain tail (_post_plain: GroupNorm,
    ReLU, the round to float32), which the layer's backward ran before."""
    y, gamma, beta, gout = _tail_inputs(10 + groups, groups, const)
    ty, tg, tb = (torch.from_numpy(v).requires_grad_()
                  for v in (y, gamma, beta))
    out = tcs._post_plain(ty, ("gn", groups, tg, tb), relu, torch.float32)
    want = torch.autograd.grad(out, (ty, tg, tb), torch.from_numpy(gout))
    gpre, g_gamma, g_beta, g_bias = _plain(y, gamma, beta, gout, groups,
                                           relu)
    for got, w in zip((gpre, g_gamma, g_beta), want):
        assert _rel(got, w) <= TOL
    assert _rel(g_bias, want[0].sum((0, 1, 2))) <= TOL


def test_gn_stats_plain_is_the_reference_formula():
    """mean and rstd from E[y^2] - mean^2 (clamped at 0) over pixels x
    channels per group, as conv_pallas.py:1774-1786 computes them; the
    constant group sits at rsqrt(eps)."""
    y, *_ = _tail_inputs(3, 4, True)
    mean, rstd = tcs.gn_stats_plain(torch.from_numpy(y), 4)
    g = y.astype(np.float64).reshape(2, -1, 4, 4)
    want_mean = g.mean((1, 3))
    var = np.maximum((g * g).mean((1, 3)) - want_mean ** 2, 0)
    assert _rel(mean, want_mean) <= TOL
    assert _rel(rstd[0], 1 / np.sqrt(var[0] + 1e-5)) <= TOL
    assert abs(float(rstd[1, 0]) - 1e-5 ** -0.5) <= TOL * 1e-5 ** -0.5


def _layer_case(seed, cin, cout, b=2, h=6, w=7):
    rng = np.random.default_rng(seed)
    kn = hex_kernel_num(2)
    x = rng.random((b, h, w, cin)).astype(np.float32)
    k = rng.normal(0, 1 / np.sqrt(kn * cin), (cout, cin, kn)).astype(
        np.float32)
    gamma = (1 + 0.2 * rng.random(cout)).astype(np.float32)
    beta = rng.normal(0, 0.2, cout).astype(np.float32)
    cot = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    return x, k, gamma, beta, cot


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("split", [False, True], ids=["layer", "split"])
def test_gn_layer_grads_match_jax_grad(split, relu):
    """hex_conv_layer and hex_conv_layer_split with a bias, GN(4) and ReLU
    on or off on the CPU (their backward: gn_relu_backward_plain, then the
    plain dgrad and wgrad): d input(s), dW, dbias, dgamma and dbeta against
    jax.grad through the JAX stack (hex_conv_stack_pallas, one layer,
    extra_input for the split)."""
    ca, cb = (5, 3) if split else (8, 0)
    x, k, gamma, beta, cot = _layer_case(20 + split, ca + cb, 8)
    bias = np.random.default_rng(30 + split).normal(0, 0.3, 8).astype(
        np.float32)

    def loss(xa, xb, k, bias, gamma, beta):
        out = jcp.hex_conv_stack_pallas(
            xa, [k], [bias], radius=2, norms=[("gn", 4, gamma, beta)],
            data_format="NHWC", extra_input=xb, final_activation=relu)
        return jnp.sum(out * cot)

    xa, xb = x[..., :ca], (x[..., ca:] if split else None)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5) if split else
                    (0, 2, 3, 4, 5))(xa, xb, k, bias, gamma, beta)
    leaves = [torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
              for v in ((xa, xb) if split else (xa,))
              + (k, bias, gamma, beta)]
    tk, tbias, tg, tb = leaves[-4:]
    kw = dict(radius=2, norm=("gn", 4, tg, tb), relu=relu)
    out = (tcs.hex_conv_layer_split(leaves[0], leaves[1], tk, tbias, **kw)
           if split else tcs.hex_conv_layer(leaves[0], tk, tbias, **kw))
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= TOL
