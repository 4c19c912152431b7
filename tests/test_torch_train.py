"""The port's training utilities against hygrid_tpu's, on the CPU, float32.

One ``train_step`` from equal parameters (carried by
``hexcnn_state_dict_from_flax``) and an equal batch: loss within 1e-5
relative, accuracy equal, every grad leaf within 1e-4 relative max-abs (GN
rescales summation-order differences), and the AdamW-updated parameters
within 5e-6 absolute where ``|g| >= 1e-3 max|g|`` of the leaf (Adam's first
step is ``+-lr * sign(g)``, so near-zero grads may step either way).  Three
steps' losses track within 1e-4 relative.  Losses and metrics of the
stateless helpers agree within 1e-6; synthetic data is equal (labels
exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu.models import train as jtrain
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.models import train as ttrain
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax

MODEL = dict(channels=(8, 16), depth=2, norm="GN")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _batch(seed, b=4, size=32):
    rect = np.random.default_rng(seed).random((b, 3, size, size)).astype(
        np.float32)
    return np.array(jm.hexify_batch(rect)), np.arange(b) % 10


def _pair(min_cells, seed=0):
    """A flax HexCNN with perturbed parameters and the port's copy of it.
    The parameters do not depend on ``stack_min_cells``: they come from
    the per-op model, whose init compiles fastest."""
    model = jm.HexCNN(stack_min_cells=min_cells, **MODEL)
    hexed, _ = _batch(seed)
    init = jax.jit(jm.HexCNN(stack_min_cells=1 << 30, **MODEL).init)
    params = jax.tree_util.tree_map(
        np.asarray, init(jax.random.key(seed), hexed[:1])["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: v + rng.normal(0, 0.1, v.shape).astype(np.float32), params)
    port = tm.HexCNN(device="cpu", **MODEL)
    port.load_state_dict(hexcnn_state_dict_from_flax(params))
    return model, params, port


def _jax_state(model, params):
    return jtrain.TrainState.create(apply_fn=model.apply, params=params,
                                    tx=optax.adamw(1e-3))


@pytest.mark.parametrize("min_cells", [0, 1024])
def test_train_step_matches_jax(min_cells):
    model, params, port = _pair(min_cells)
    hexed, labels = _batch(1)
    new_state, want = jax.jit(jm.train_step)(_jax_state(model, params),
                                             hexed, labels)
    want_params = hexcnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, new_state.params))
    # after one step Adam's first moment is (1 - b1) * grad, b1 = 0.9: the
    # step's grads without compiling the model a second time
    mu = new_state.opt_state[0].mu
    want_grads = hexcnn_state_dict_from_flax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu))

    state, got = tm.train_step(tm.create_train_state(port), _t(hexed),
                               _t(labels))
    assert state.step == 1
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    for name, p in port.named_parameters():
        g = want_grads[name].numpy()
        assert _rel(p.grad.numpy(), g) <= 1e-4, name
        sel = np.abs(g) >= 1e-3 * np.abs(g).max()
        diff = np.abs(p.detach().numpy() - want_params[name].numpy())[sel]
        assert diff.max() <= 5e-6, name


def test_three_steps_track_jax():
    model, params, port = _pair(1024, seed=2)
    jstate, state = _jax_state(model, params), tm.create_train_state(port)
    step = jax.jit(jm.train_step)
    for seed in (3, 4, 5):
        hexed, labels = _batch(seed)
        jstate, want = step(jstate, hexed, labels)
        state, got = tm.train_step(state, _t(hexed), _t(labels))
        assert abs(float(got["loss"]) - float(want["loss"])) \
            <= 1e-4 * abs(float(want["loss"]))


def test_eval_step_matches_jax():
    model, params, port = _pair(1024, seed=6)
    hexed, labels = _batch(7)
    want = jm.eval_step(_jax_state(model, params), hexed, labels)
    got = tm.eval_step(tm.create_train_state(port), _t(hexed), _t(labels))
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= 1e-5 * abs(float(want["loss"]))
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert all(p.grad is None for p in port.parameters())


@pytest.mark.parametrize("shape", [(6, 10), (2, 4, 5, 3)])
def test_dense_onehot_xent_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    logits = rng.normal(0, 2, shape).astype(np.float32)
    if len(shape) == 2:
        labels = rng.integers(0, shape[-1], shape[0])
        labels[1] = shape[-1]             # out of range: an all-zero row
    else:
        labels = rng.integers(0, shape[1], (shape[0],) + shape[2:])
    jl = jtrain._class_axis_last(jnp.asarray(logits), jnp.asarray(labels))
    tl = ttrain._class_axis_last(_t(logits), _t(labels))
    assert tuple(tl.shape) == jl.shape
    want = float(jm.dense_onehot_xent(jl, labels))
    got = float(tm.dense_onehot_xent(tl, _t(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("layout", ["BKhw", "NK"])
def test_mean_iou_matches_jax(layout):
    """Per-cell (B, K, h, w) logits and flat (N, K) logits with (N,)
    labels, where the class axis is already last."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(2, 4, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 5))      # class 3 only in predictions
    if layout == "NK":
        logits = np.ascontiguousarray(np.moveaxis(logits, 1, -1).reshape(
            -1, 4))
        labels = labels.reshape(-1)
    want = float(jm.mean_iou(logits, labels, 5))
    got = float(tm.mean_iou(_t(logits), _t(labels), 5))
    assert abs(got - want) <= 1e-6


def test_synthetic_data_matches_jax():
    for name, kw, where in (("synthetic_hex_cifar", dict(size=32),
                             dict(device="cpu")),
                            ("synthetic_hex_shapes", dict(size=32), {})):
        want_x, want_y = getattr(jm, name)(np.random.default_rng(3), 5, **kw)
        got_x, got_y = getattr(tm, name)(np.random.default_rng(3), 5, **kw,
                                         **where)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_fit_history_matches_jax_shape():
    data = [_batch(s, b=2) for s in (10, 11, 12)]
    evals = [_batch(13, b=2)]
    kw = dict(num_epochs=2, eval_data=evals, log_every=2)
    _, want = jm.fit(jm.HexCNN(channels=(8, 16), depth=1, norm="GN"), data,
                     **kw)
    state, got = tm.fit(tm.HexCNN(channels=(8, 16), depth=1, norm="GN",
                                  device="cpu"), data, **kw)
    assert state.step == 6
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in want.items()} == \
        {"loss": 4, "accuracy": 4, "eval_loss": 2, "eval_accuracy": 2}
    assert all(np.isfinite(v) for v in got["loss"] + got["eval_loss"])


def test_create_train_state_uses_optax_adamw_defaults():
    state = tm.create_train_state(tm.HexCNN(device="cpu", **MODEL),
                                  learning_rate=3e-4)
    opt = state.optimizer
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(list(state.model.parameters()))
    sgd = tm.create_train_state(tm.HexCNN(device="cpu", **MODEL),
                                tx=lambda p: torch.optim.SGD(p, lr=0.1))
    assert isinstance(sgd.optimizer, torch.optim.SGD)
    # BatchNorm's running statistics are buffers, not optimised (flax's
    # batch_stats beside optax's params)
    bn = tm.create_train_state(tm.HexCNN(device="cpu",
                                         **dict(MODEL, norm="BN")))
    params = bn.optimizer.param_groups[0]["params"]
    assert len(params) == len(list(bn.model.parameters()))
    assert not {id(b) for b in bn.model.buffers()} & {id(p) for p in params}


@pytest.mark.parametrize("option", [dict(mesh="dp 1"),
                                    dict(checkpoint_path="ckpt")])
def test_fit_unported_options_raise(option, tmp_path):
    """``mesh`` and ``checkpoint_path`` raised until ``parallel/`` and
    ``utils/checkpoint.py`` were ported; now ``fit`` takes them: over a
    one-rank ``dp`` mesh (a gloo group in this process, destroyed after)
    it gives the history of ``fit`` without one, bit for bit, and the
    checkpoint of the last epoch restores the trained parameters."""
    import torch.distributed as dist
    from hygrid_tpu_torch import parallel, utils
    batches = [_batch(0, b=2), _batch(1, b=2)]
    runs = []
    for use in (False, True):
        torch.manual_seed(0)
        model = tm.HexCNN(device="cpu", **MODEL)
        kw = {}
        if use and "mesh" in option:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                world_size=1)
            kw["mesh"] = parallel.create_mesh({"dp": 1})
        elif use:
            kw["checkpoint_path"] = str(tmp_path / option["checkpoint_path"])
        try:
            runs.append((model, tm.fit(model, batches, num_epochs=2,
                                       log_every=1, **kw)[1]))
        finally:
            if "mesh" in kw:
                dist.destroy_process_group()
    assert runs[0][1] == runs[1][1]
    if "checkpoint_path" in option:
        fresh = tm.HexCNN(device="cpu", **MODEL)
        utils.restore_checkpoint(str(tmp_path / "ckpt_e1.npz"), fresh)
        for a, b in zip(fresh.parameters(), runs[1][0].parameters()):
            assert torch.equal(a, b)
