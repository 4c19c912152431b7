"""The port's conv-layer backward against hygrid_tpu's, on the CPU.

* the adjoint tap table and the dW indexing, emulated in numpy as the
  CUDA kernels index, against ``jax.vjp`` of ``hex_conv2d(impl="direct")``
  (float64 emulation vs float32 XLA: 1e-5 relative);
* ``hex_conv_layer_dgrad_plain`` / ``_wgrad_plain`` against ``jax.grad``
  through ``hex_conv_stack_pallas``, whose custom VJP runs the hand-written
  Pallas backward (``_stack_layer_bwd_kernel``) in interpret mode
  (2e-5 relative: summation order only);
* grads of ``HexConvStack`` (GN and norm-free) through the port's
  autograd Function against the flax ``HexConvStack`` (1e-4 relative: GN
  rescales summation-order differences);
* ``plan_gather_vjp_plain`` against ``jax.vjp`` of ``apply_plan`` (1e-6).

Relative errors are max-abs over the largest magnitude of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hygrid_tpu.kernels.conv_pallas as jcp
from hygrid_tpu.nn import functional as JF
from hygrid_tpu.nn.layers import HexConvStack as JHexConvStack
from hygrid_tpu.ops import sampling as jsampling
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.kernels import resample as trs
from hygrid_tpu_torch.nn import HexConvStack
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.ops import geometry as tgeo


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_conv_vjp(x_nhwc, k, g_nhwc, radius, dilation):
    """(dL/dx, dL/dk) of hygrid_tpu's direct 'same' conv for cotangent g."""
    def conv(x, k):
        return JF.hex_conv2d(jnp.moveaxis(x, -1, 1), k, radius=radius,
                             padding=dilation * (radius - 1),
                             dilation=dilation, impl="direct")

    @jax.jit
    def pullback(x, k, g):
        return jax.vjp(conv, x, k)[1](jnp.moveaxis(g, -1, 1))

    dx, dk = pullback(x_nhwc, k, g_nhwc)
    return np.asarray(dx), np.asarray(dk)


def _adjoint_conv(g, kernel, table):
    """Emulates the CUDA dx launch: the conv pass on the adjoint table,
    input pixel (i, j) with parity p = i % 2 sums
    kernel[:, :, t]^T @ g[i + A[p,t,0], j + A[p,t,1]] (zero outside)."""
    b, h, w, _ = g.shape
    out = np.zeros((b, h, w, kernel.shape[1]), np.float64)
    for p in (0, 1):
        for t in range(table.shape[1]):
            dr, dc = table[p, t]
            for i in range(p, h, 2):
                o = i + dr
                if not 0 <= o < h:
                    continue
                j0, j1 = max(0, -dc), min(w, w - dc)
                out[:, i, j0:j1] += g[:, o, j0 + dc:j1 + dc] @ kernel[:, :, t]
    return out


def _weight_grad(x, g, table):
    """Emulates hex_conv_wgrad: dW[co, ci, t] = sum over (b, o, j) of
    x[b, o + T[q,t,0], j + T[q,t,1], ci] * g[b, o, j, co], q = o % 2."""
    b, h, w, cin = x.shape
    dw = np.zeros((g.shape[-1], cin, table.shape[1]), np.float64)
    for q in (0, 1):
        for t in range(table.shape[1]):
            dr, dc = table[q, t]
            for o in range(q, h, 2):
                i = o + dr
                if not 0 <= i < h:
                    continue
                j0, j1 = max(0, -dc), min(w, w - dc)
                dw[:, :, t] += np.einsum("bjc,bjd->dc",
                                         x[:, i, j0 + dc:j1 + dc],
                                         g[:, o, j0:j1])
    return dw


RADIUS_DILATION = [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 1)]


@pytest.mark.parametrize("radius,dilation", RADIUS_DILATION)
@pytest.mark.parametrize("hw", [(10, 9), (9, 12)])
def test_adjoint_tap_table_and_wgrad_indexing_match_jax_vjp(radius,
                                                            dilation, hw):
    """The dx kernel's adjoint table and the dW kernel's indexing reproduce
    jax.vjp of the direct conv, on odd and even heights and widths."""
    h, w = hw
    kn = TF.hex_kernel_num(radius)
    table = TF.hex_adjoint_tap_table(radius, dilation)
    assert table.shape == (2, kn, 2) and table.dtype == np.int32
    rng = np.random.default_rng(radius * 10 + dilation + h)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    k = rng.normal(0, 0.5, (5, 3, kn)).astype(np.float32)
    g = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    want_dx, want_dk = _jax_conv_vjp(x, k, g, radius, dilation)
    assert _rel(_adjoint_conv(g, k, table), want_dx) <= 1e-5
    fwd = TF.hex_tap_table(radius, dilation)
    assert _rel(_weight_grad(x, g, fwd), want_dk) <= 1e-5


def test_dgrad_wgrad_plain_match_pallas_backward(monkeypatch):
    """One-layer stack at C=16, 12x11, b=4, no norm or activation: dL/dx
    and dL/dW of sum(stack(x, k) * g) are the layer's dgrad(g, k) and
    wgrad(x, g)."""
    taken = []
    orig = jcp._stack_bwd_pallas

    def spy(statics, res, ct):
        out = orig(statics, res, ct)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(jcp, "_stack_bwd_pallas", spy)
    b, h, w, c = 4, 12, 11, 16
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.2, (c, c, 7)).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)

    def loss(x, k):
        out = jcp.hex_conv_stack_pallas(x, [k], None, radius=2,
                                        activation=None, data_format="NHWC")
        return jnp.sum(out * g)

    want_dx, want_dk = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, k)
    assert taken == [True]          # the hand-written Pallas backward ran
    got_dx = tcs.hex_conv_layer_dgrad_plain(_t(g), _t(k), radius=2)
    got_dk = tcs.hex_conv_layer_wgrad_plain(_t(x), _t(g), radius=2)
    assert _rel(got_dx.numpy(), want_dx) <= 2e-5
    assert _rel(got_dk.numpy(), want_dk) <= 2e-5


def _stack_params(rng, norm):
    """Random flax-named parameters of a HexConvStack 3 -> 16, depth 2."""
    params = {"kernel_0": rng.normal(0, 0.3, (16, 3, 7)),
              "kernel_1": rng.normal(0, 0.1, (16, 16, 7))}
    for i in (0, 1):
        if norm == "GN":
            params[f"gn_scale_{i}"] = 1 + rng.normal(0, 0.1, 16)
            params[f"gn_bias_{i}"] = rng.normal(0, 0.1, 16)
        else:
            params[f"bias_{i}"] = rng.normal(0, 0.1, 16)
    return {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("min_cells", [0, 1024])
@pytest.mark.parametrize("norm", ["GN", None])
def test_hexconvstack_grads_match_jax(norm, min_cells):
    """HexConvStack 3 -> 16, depth 2: grads of every parameter and of the
    input, the same weights on both sides by name; JAX runs the Pallas
    stack (min_cells=0) or its per-op chain."""
    rng = np.random.default_rng(7)
    x = rng.random((2, 12, 11, 3)).astype(np.float32)
    params = _stack_params(rng, norm)
    g = rng.normal(size=(2, 12, 11, 16)).astype(np.float32)
    jm = JHexConvStack(in_channels=3, width=16, depth=2, norm=norm,
                       min_cells=min_cells, data_format="NHWC")

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * g)

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    tm = HexConvStack(3, 16, 2, norm=norm, data_format="NHWC", device="cpu")
    tm.load_state_dict({k: _t(v) for k, v in params.items()})
    xt = _t(x).requires_grad_()
    (tm(xt) * _t(g)).sum().backward()
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), want_p[name]) <= 1e-4, name
    assert _rel(xt.grad.numpy(), want_x) <= 1e-4


@pytest.mark.parametrize("norm,relu", [("GN", True), ("GN", False),
                                       (None, True), (None, False)])
def test_layer_function_matches_plain_autograd(norm, relu):
    """hex_conv_layer (the autograd Function, plain versions inside on the
    CPU) gives the grads that autograd of hex_conv_layer_plain gives.

    Tolerance 1e-6 without a norm, where both sides are autograd of the
    same plain conv.  With GN 2e-5: the Function pulls back through the
    closed-form vjp at E[y^2] - mean^2 statistics, the reference through
    autograd of torch.var, and each lies about 2e-7 of the largest grad
    from a float64 evaluation (8.6e-6 apart at most here, on dW)."""
    rng = np.random.default_rng(3)
    x = _t(rng.random((2, 9, 11, 4)).astype(np.float32)).requires_grad_()
    k = _t(rng.normal(0, 0.2, (8, 4, 7)).astype(np.float32)).requires_grad_()
    vecs = [_t(rng.normal(0, 0.2, 8).astype(np.float32)).requires_grad_()
            for _ in range(3)]
    bias = vecs[0]
    nm = ("gn", 4, 1 + vecs[1], vecs[2]) if norm else None
    leaves = [x, k] + vecs
    w = _t(rng.normal(size=(2, 9, 11, 8)).astype(np.float32))
    grads = []
    for fn in (tcs.hex_conv_layer, tcs.hex_conv_layer_plain):
        out = fn(x, k, bias, radius=2, norm=nm, relu=relu)
        grads.append(torch.autograd.grad((out * w).sum(), leaves,
                                         allow_unused=True))
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            tol = 2e-5 if norm else 1e-6
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                       atol=tol)


def test_layer_backward_skips_dx_of_an_input_without_grad(monkeypatch):
    calls = []
    orig = tcs.hex_conv_layer_dgrad

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tcs, "hex_conv_layer_dgrad", spy)
    tm = HexConvStack(3, 8, 3, norm="GN", data_format="NHWC", device="cpu")
    tm(torch.rand(1, 8, 7, 3)).sum().backward()
    assert len(calls) == 2
    assert all(p.grad is not None for p in tm.parameters())


PLANS = {  # the port's plans, bit-equal to hygrid_tpu's (test_torch_geometry)
    "r2h-40x36-bilinear": lambda: tgeo.rect_to_hex_plan(40, 36, 20, 18,
                                                        "bilinear"),
    "h2r-17x15-linear": lambda: tgeo.hex_to_rect_plan(17, 15, 34, 30,
                                                      "linear"),
    "resize-20x18-bilinear": lambda: tgeo.hexresize_plan(20, 18, 13, 27,
                                                         "bilinear"),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_gather_vjp_matches_jax(name):
    tplan = PLANS[name]()
    jplan = jsampling.SamplePlan(tplan.idx, tplan.weights, tplan.src_shape,
                                 tplan.out_shape, tplan.exact_select)
    rng = np.random.default_rng(len(name))
    x = rng.random((2, 3) + tplan.src_shape).astype(np.float32)
    out, vjp = jax.vjp(lambda v: jsampling.apply_plan(v, jplan), x)
    g = rng.normal(size=out.shape).astype(np.float32)
    (want,) = vjp(g)
    got = trs.plan_gather_vjp_plain(_t(g), tplan)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    xt = _t(x).requires_grad_()
    (trs.plan_gather(xt, tplan) * _t(g)).sum().backward()
    assert torch.equal(xt.grad, got)
