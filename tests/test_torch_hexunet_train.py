"""HexUNet training on the CPU: the split layer's backward and the port's
``train_step`` / ``fit`` against hygrid_tpu's, float32, at tiny sizes.

* The split layer (``hex_conv_stack(extra_input=)``, layer 0 split, layer
  1 plain): dA, dB, dW, db, dgamma and dbeta against ``jax.grad`` of
  ``hex_conv_stack_pallas(extra_input=)``, on the reference's interpreted
  Pallas hand path (``_stack_bwd_pallas``, asserted as taken) at Ca = Cb
  and on its XLA twin at Ca != Cb: relative max-abs error <= 1e-4 with
  GroupNorm (it rescales summation-order differences), 1e-5 without.
* One ``train_step`` of ``HexUNet`` (widths (8, 16), 32^2 rect -> 16^2
  hex, b=2, per-cell labels) from the weights ``hexunet_state_dict_from_
  flax`` carries, against ``hygrid_tpu.models.train_step`` on its XLA
  chain and on its interpreted Pallas stack and split kernels: loss within
  1e-5 relative, accuracy equal, every grad leaf within 1e-4 relative
  (taken from Adam's first moment, mu / 0.1), the updated parameters within
  5e-6 where ``|g| >= 1e-3 max|g|`` of the leaf (Adam's first step is
  ``+-lr * sign(g)``, so near-zero grads may step either way).  Three
  steps' losses track within 1e-4, and ``mean_iou`` of the logits after
  them is equal.
* ``hex_pool2d`` max grads with tied window cells equal ``jax.grad``'s.
* ``fit`` gives the history of ``train_step`` called on the batches in
  turn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu.models import hexunet as jhexunet
from hygrid_tpu.models import train as jtrain
from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.kernels import pool as tpool
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.nn.functional import hex_kernel_num
from hygrid_tpu_torch.utils import hexunet_state_dict_from_flax
from test_torch_modules import random_flax_variables


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def hand_path(monkeypatch):
    """Count the reference's hand-written stack pullbacks and fallbacks."""
    calls = {"hand": 0, "fallback": 0}
    orig = jcp._stack_bwd_pallas

    def wrapped(statics, res, g):
        out = orig(statics, res, g)
        calls["hand" if out is not None else "fallback"] += 1
        return out

    monkeypatch.setattr(jcp, "_stack_bwd_pallas", wrapped)
    return calls


# ---- the split layer's backward --------------------------------------------

def _split_case(seed, ca, cb, cout, gn, b=2, h=8, w=8):
    """Inputs, a 2-layer stack's parameters and an output cotangent."""
    rng = np.random.default_rng(seed)
    kn = hex_kernel_num(2)
    xa = rng.random((b, h, w, ca)).astype(np.float32)
    xb = rng.random((b, h, w, cb)).astype(np.float32)
    ks = [rng.normal(0, 1 / np.sqrt(kn * c), (cout, c, kn)).astype(np.float32)
          for c in (ca + cb, cout)]
    if gn:
        bs = None
        gs = [1 + 0.2 * rng.random(cout).astype(np.float32) for _ in ks]
        bts = [rng.normal(0, 0.2, cout).astype(np.float32) for _ in ks]
    else:
        bs = [rng.normal(0, 0.1, cout).astype(np.float32) for _ in ks]
        gs = bts = None
    cot = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    return xa, xb, ks, bs, gs, bts, cot


def _jax_split_grads(xa, xb, ks, bs, gs, bts, cot):
    def loss(xa, xb, ks, bs, gs, bts):
        norms = None if gs is None else [("gn", 4, g, bt)
                                         for g, bt in zip(gs, bts)]
        out = jcp.hex_conv_stack_pallas(xa, ks, bs, radius=2, norms=norms,
                                        data_format="NHWC", extra_input=xb)
        return jnp.sum(out * cot)

    return jax.grad(loss, argnums=tuple(range(6)))(xa, xb, ks, bs, gs, bts)


def _port_split_grads(xa, xb, ks, bs, gs, bts, cot):
    leaves = [_t(v).requires_grad_() for v in (xa, xb)]
    tk = [_t(k).requires_grad_() for k in ks]
    tb = None if bs is None else [_t(v).requires_grad_() for v in bs]
    norms = None
    if gs is not None:
        tg = [_t(v).requires_grad_() for v in gs]
        tbt = [_t(v).requires_grad_() for v in bts]
        norms = [("gn", 4, g, bt) for g, bt in zip(tg, tbt)]
    out = tcs.hex_conv_stack(leaves[0], tk, tb, radius=2, norms=norms,
                             data_format="NHWC", extra_input=leaves[1])
    (out * _t(cot)).sum().backward()
    grads = [leaves[0].grad, leaves[1].grad, [k.grad for k in tk],
             None if tb is None else [v.grad for v in tb]]
    grads += [None, None] if norms is None else [[n[2].grad for n in norms],
                                                 [n[3].grad for n in norms]]
    return grads


def _assert_split_grads(case, tol):
    want = _jax_split_grads(*case)
    got = _port_split_grads(*case)
    names = ["dA", "dB", "dW", "db", "dgamma", "dbeta"]
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        for i, (gi, wi) in enumerate(zip(*((g, w) if isinstance(g, list)
                                          else ([g], [w])))):
            assert _rel(gi, wi) <= tol, (name, i)


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "bias"])
def test_split_layer_grads_match_pallas_hand_path(gn, hand_path):
    """Ca = Cb = Cout = 8: the reference pulls the split layer back through
    its interpreted Pallas backward kernel (#12 on (A, Ka) and (B, Kb))."""
    _assert_split_grads(_split_case(1, 8, 8, 8, gn), 1e-4 if gn else 1e-5)
    assert hand_path["hand"] >= 1 and hand_path["fallback"] == 0, hand_path


@pytest.mark.parametrize("ca,cb", [(24, 8), (5, 11)])
def test_split_layer_grads_match_xla_twin(ca, cb):
    """Splits the TPU kernel does not take pull back through the
    reference's XLA twin; the port runs its split backward for all."""
    _assert_split_grads(_split_case(ca, ca, cb, 16, True, h=10, w=9), 1e-4)


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "bias"])
def test_split_layer_backward_is_autograd_of_the_concatenation(gn):
    """On the CPU the split layer's Function (split dgrad and wgrad) equals
    torch autograd through hex_conv_layer_plain on torch.cat, and its
    wrappers equal the unsplit backward cut at Ca."""
    xa, xb, ks, bs, gs, bts, cot = _split_case(7, 12, 4, 8, gn, h=6, w=5)
    norm = None if gs is None else ("gn", 4, _t(gs[0]), _t(bts[0]))
    bias = None if bs is None else _t(bs[0])
    k = _t(ks[0])
    grads = []
    for split in (True, False):
        a, b, kk = (_t(v).requires_grad_() for v in (xa, xb, ks[0]))
        kw = dict(radius=2, norm=norm, relu=True)
        out = (tcs.hex_conv_layer_split(a, b, kk, bias, **kw) if split else
               tcs.hex_conv_layer_plain(torch.cat([a, b], -1), kk, bias,
                                        **kw))
        (out * _t(cot)).sum().backward()
        grads.append((a.grad, b.grad, kk.grad))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5
    g = _t(cot)
    da, db = tcs.hex_conv_layer_split_dgrad(g, k, 12, radius=2)
    dx = tcs.hex_conv_layer_dgrad(g, k, radius=2)
    assert torch.equal(da, dx[..., :12]) and torch.equal(db, dx[..., 12:])
    assert torch.equal(
        tcs.hex_conv_layer_split_wgrad(_t(xa), _t(xb), g, radius=2),
        tcs.hex_conv_layer_wgrad(torch.cat([_t(xa), _t(xb)], -1), g,
                                 radius=2))


# ---- HexUNet train_step ------------------------------------------------------

NUM_CLASSES = 4
_jit_step = jax.jit(jm.train_step)


def _batch(seed, b=2, size=32):
    """Hex images (JAX's hexify) and per-cell labels drawn as
    ``benchmarks/suite.py::bench_hexunet_train`` draws them."""
    rng = np.random.default_rng(seed)
    rect = rng.random((b, 3, size, size)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (b, size // 2, size // 2))
    return np.asarray(jm.hexify_batch(rect)), labels


def _unet_pair(kw, seed, min_cells=10 ** 9):
    hexed, _ = _batch(seed)
    model = jm.HexUNet(num_classes=NUM_CLASSES, stack_min_cells=min_cells,
                       **kw)
    params = random_flax_variables(model, hexed, seed)["params"]
    port = tm.HexUNet(num_classes=NUM_CLASSES, device="cpu", **kw)
    port.load_state_dict(hexunet_state_dict_from_flax(params))
    state = jtrain.TrainState.create(apply_fn=model.apply, params=params,
                                     tx=optax.adamw(1e-3))
    return state, port


def _assert_step_matches(jstate, port, hexed, labels, step=_jit_step):
    new_state, want = step(jstate, hexed, labels)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want_params = hexunet_state_dict_from_flax(to_np(new_state.params))
    # after one step Adam's first moment is (1 - b1) * grad, b1 = 0.9
    want_grads = hexunet_state_dict_from_flax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, new_state.opt_state[0].mu))
    state, got = tm.train_step(tm.create_train_state(port), _t(hexed),
                               torch.from_numpy(labels))
    assert state.step == 1
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, p in named.items():
        g = want_grads[name].numpy()
        assert _rel(p.grad, g) <= 1e-4, name
        sel = np.abs(g) >= 1e-3 * np.abs(g).max()
        diff = np.abs(p.detach().numpy() - want_params[name].numpy())[sel]
        assert diff.max() <= 5e-6, name


@pytest.mark.parametrize("upsample", ["transpose", "pixelshuffle"])
def test_train_step_matches_jax_xla_chain(upsample):
    """hygrid_tpu's stage-wise route on its XLA chain
    (``stack_min_cells=10**9``)."""
    kw = dict(widths=(8, 16), norm="GN", upsample=upsample)
    jstate, port = _unet_pair(kw, 1)
    _assert_step_matches(jstate, port, *_batch(2))


def test_train_step_matches_jax_pallas_kernels(monkeypatch, hand_path):
    """``stack_min_cells=0`` with the packed encoder off: hygrid_tpu runs
    its Pallas stack kernel for the encoder, the split kernel (#10s) for
    the decoder and their hand-written backward (#12, 12s), interpreted."""
    monkeypatch.setattr(jhexunet.HexUNet, "_packed_chain_ok",
                        lambda self, *a: False)
    jstate, port = _unet_pair(dict(widths=(8, 16), norm="GN"), 3,
                              min_cells=0)
    _assert_step_matches(jstate, port, *_batch(4), step=jm.train_step)
    assert hand_path["hand"] >= 1, hand_path


def test_three_steps_track_jax_and_mean_iou_agrees():
    kw = dict(widths=(8, 16), norm="GN", upsample="transpose")
    jstate, port = _unet_pair(kw, 5)
    state = tm.create_train_state(port)
    for seed in (6, 7, 8):
        hexed, labels = _batch(seed)
        jstate, want = _jit_step(jstate, hexed, labels)
        state, got = tm.train_step(state, _t(hexed), torch.from_numpy(labels))
        assert abs(float(got["loss"]) - float(want["loss"])) \
            <= 1e-4 * abs(float(want["loss"]))
    hexed, labels = _batch(9)
    want_logits = jax.jit(jstate.apply_fn)({"params": jstate.params}, hexed)
    with torch.no_grad():
        got_logits = port(_t(hexed))
    assert _rel(got_logits, want_logits) <= 1e-4
    want = float(jm.mean_iou(want_logits, labels, NUM_CLASSES))
    got = float(tm.mean_iou(got_logits, torch.from_numpy(labels),
                            NUM_CLASSES))
    assert got == want


# ---- hex_pool2d max with ties ----------------------------------------------

@pytest.mark.parametrize("data_format,kernel,stride", [
    ("NHWC", 2, 2), ("NCHW", 2, 2), ("NHWC", 3, 2), ("NHWC", (1, 2), 3),
    ("NHWC", (2, 1), 2), ("NHWC", 2, 3)])
def test_max_pool_tie_grads_match_jax(data_format, kernel, stride):
    """ReLU'd values on a coarse grid tie in most windows (two, three or
    four cells): the split of each tie's gradient is jax.grad's (rows
    first, then columns, for the non-overlapping model pool: bit for bit;
    evenly over the flat window otherwise, within a float32 ulp).  The
    non-overlapping NHWC pools give the same bits through the
    ``hygrid::hex_max_pool`` op and its backward (the kernel's plain
    version, ``kernels/pool.py``)."""
    rng = np.random.default_rng(kernel)
    shape = (2, 9, 10, 3) if data_format == "NHWC" else (2, 3, 9, 10)
    x = np.maximum(np.round(rng.normal(0, 1, shape) * 2) / 2, 0).astype(
        np.float32)
    kw = dict(kernel_size=kernel, stride=stride, data_format=data_format)
    ref = JF.hex_pool2d(x, "max", **kw)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(JF.hex_pool2d(v, "max", **kw) * cot))(
        jnp.asarray(x))
    t = _t(x).requires_grad_()
    out = TF.hex_pool2d(t, "max", device="cpu", **kw)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (out * _t(cot)).sum().backward()
    if np.max(kernel) > stride:   # overlapping windows sum their cells'
        np.testing.assert_allclose(  # shares in another order
            t.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        return
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    if data_format == "NHWC":
        t = _t(x).requires_grad_()
        k = (kernel, kernel) if isinstance(kernel, int) else kernel
        out = tpool.hex_max_pool(t, k, (stride, stride))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        (out * _t(cot)).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


# ---- fit ---------------------------------------------------------------------

def test_fit_history_is_train_step_in_turn():
    """fit over three synthetic_hex_shapes batches on the CPU: per-step
    losses and accuracies equal to train_step called on them in turn."""
    images, labels = tm.synthetic_hex_shapes(np.random.default_rng(0), 6,
                                             size=32)
    data = [(images[i:i + 2], labels[i:i + 2]) for i in range(0, 6, 2)]
    kw = dict(num_classes=4, widths=(8, 16), norm="GN", device="cpu")
    model = tm.HexUNet(generator=torch.Generator().manual_seed(0), **kw)
    twin = tm.HexUNet(**kw)
    twin.load_state_dict(model.state_dict())
    state, history = tm.fit(model, data, log_every=1)
    assert state.step == 3
    ref = tm.create_train_state(twin)
    losses, accs = [], []
    for x, y in data:
        ref, metrics = tm.train_step(ref, x, y)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
    assert history["loss"] == losses and history["accuracy"] == accs
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), name
