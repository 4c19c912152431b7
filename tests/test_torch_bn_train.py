"""Training with BatchNorm on the CPU: one ``train_step`` of
``hexcnn_tiny(norm="BN")`` against ``hygrid_tpu.models.train_step`` (jitted)
from the same variables, carried by ``hexcnn_state_dict_from_flax`` with
their ``batch_stats``.

The reference's step normalises with the batch's statistics and returns
the updated running statistics (``train=True``, ``batch_stats`` mutable);
the port's must too, and its ``eval_step`` must read the running ones.
Float32: the loss within 1e-5 relative, accuracy equal, every grad leaf
(taken from Adam's first moment, mu / 0.1) and the new running mean and
variance within 1e-4 relative max-abs error (BN rescales summation-order
differences); ``eval_step``'s loss within 1e-5 relative.
"""
import jax
import numpy as np
import optax
import torch

from hygrid_tpu import models as jm
from hygrid_tpu.models import train as jtrain
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax
from test_torch_modules import random_flax_variables


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(seed):
    rng = np.random.default_rng(seed)
    rect = rng.random((4, 3, 32, 32)).astype(np.float32)
    hexed = np.array(jm.hexify_batch(rect))
    labels = np.arange(4) % 10
    model = jm.hexcnn_tiny(norm="BN")
    variables = random_flax_variables(model, hexed[:1], seed)
    state = jtrain.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.adamw(1e-3))
    port = tm.hexcnn_tiny(norm="BN", device="cpu")
    port.load_state_dict(hexcnn_state_dict_from_flax(_np(variables)))
    return state, port, torch.from_numpy(hexed), torch.from_numpy(labels)


def test_bn_train_step_matches_jax():
    state, port, x, y = _setup(0)
    new_state, want = jax.jit(jm.train_step)(state, x.numpy(), y.numpy())
    got_state, got = tm.train_step(tm.create_train_state(port), x, y)
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])
    mu = new_state.opt_state[0].mu
    want_grads = hexcnn_state_dict_from_flax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu))
    for name, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want_grads[name].numpy()) <= 1e-4, name
    # the running statistics: updated from the batch's, as flax's
    want_sd = hexcnn_state_dict_from_flax(
        {"params": _np(new_state.params),
         "batch_stats": _np(new_state.batch_stats)})
    buffers = dict(port.named_buffers())
    assert buffers and all(n.endswith(("running_mean", "running_var"))
                           for n in buffers)
    old = hexcnn_state_dict_from_flax(
        {"params": _np(state.params), "batch_stats": _np(state.batch_stats)})
    for name, buf in buffers.items():
        assert not np.allclose(buf.numpy(), old[name].numpy()), name
        assert _rel(buf.numpy(), want_sd[name].numpy()) <= 1e-4, name


def test_bn_eval_step_reads_running_statistics():
    state, port, x, y = _setup(1)
    want = jm.eval_step(state, x.numpy(), y.numpy())
    got = tm.eval_step(tm.create_train_state(port), x, y)
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])
    # eval changes no running statistic
    before = {n: b.clone() for n, b in port.named_buffers()}
    tm.eval_step(tm.create_train_state(port), x, y)
    assert all(torch.equal(b, before[n]) for n, b in port.named_buffers())
