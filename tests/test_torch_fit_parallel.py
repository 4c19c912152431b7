"""Data-parallel training in the port: ``train_step(mesh=)`` and
``fit(mesh=, checkpoint_path=)`` on a 4-rank gloo world (``dp`` = 4, two
images a rank), against ``hygrid_tpu.models.train_step`` (jitted) on the
global batch of 8, from the same flax variables carried by
``hexcnn_state_dict_from_flax``.

Without norms: the loss within 1e-5 relative, the parameters after the
AdamW step within 1e-5 absolute.  With BatchNorm (statistics summed over
the ``dp`` group in the forward): parameters and running statistics
within 1e-4 relative max-abs error, as ``test_torch_bn_train.py`` holds
one process's step.  ``fit`` over the mesh: every rank ends with rank 0's
history and parameters, only rank 0 writes ``ck_e{epoch}.npz``, the last
one restores bit-equal, and the history matches one process's ``fit`` on
the global batches within 1e-4 relative.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu.models import train as jtrain
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch.parallel import host_local_batch_slice
from hygrid_tpu_torch.utils import hexcnn_state_dict_from_flax
from test_torch_modules import random_flax_variables
import torch_ranks as tr


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def setup():
    x, y = jm.synthetic_hex_cifar(np.random.default_rng(0), 8)
    x, y = np.asarray(x), np.asarray(y)
    payload = {"x": x, "y": y}
    refs = {}
    for norm in ("none", "BN"):
        model = jm.hexcnn_tiny(norm=None if norm == "none" else "BN")
        variables = random_flax_variables(model, x[:1], 1)
        state = jtrain.TrainState.create(
            apply_fn=model.apply, params=variables["params"],
            batch_stats=variables.get("batch_stats"), tx=optax.adamw(1e-3))
        new_state, metrics = jax.jit(jm.train_step)(state, x, y)
        refs[norm] = (new_state, metrics)
        payload[f"sd_{norm}"] = {
            k: v.numpy() for k, v in hexcnn_state_dict_from_flax(
                _np(variables)).items()}
    xb, yb = jm.synthetic_hex_cifar(np.random.default_rng(0), 32)
    payload["batches"] = [(np.asarray(xb[i:i + 8]), np.asarray(yb[i:i + 8]))
                          for i in range(0, 32, 8)]
    return payload, refs, tr.run_world("dp_world", 4, payload)


def _ref_state_dict(state):
    tree = {"params": _np(state.params)}
    if state.batch_stats is not None:
        tree["batch_stats"] = _np(state.batch_stats)
    return {k: v.numpy() for k, v in hexcnn_state_dict_from_flax(tree).items()}


def test_dp_train_step_without_norms(setup):
    """The case of ``test_models_parallel.py:203-222``."""
    _, refs, ranks = setup
    new_state, metrics = refs["none"]
    want = _ref_state_dict(new_state)
    for rank in ranks:
        got = rank["step_none"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        assert got["accuracy"] == float(metrics["accuracy"])
        for name, value in want.items():
            np.testing.assert_allclose(got["state"][name], value, atol=1e-5,
                                       err_msg=name)


def test_dp_train_step_with_batchnorm(setup):
    _, refs, ranks = setup
    new_state, metrics = refs["BN"]
    want = _ref_state_dict(new_state)
    assert any(k.endswith("running_var") for k in want)
    for rank in ranks:
        got = rank["step_BN"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        for name, value in want.items():
            assert _rel(got["state"][name], value) <= 1e-4, name


def test_dp_ranks_hold_one_state(setup):
    _, _, ranks = setup
    for norm in ("none", "BN"):
        first = ranks[0][f"step_{norm}"]
        for rank in ranks[1:]:
            for name, value in first["state"].items():
                np.testing.assert_array_equal(rank[f"step_{norm}"]["state"]
                                              [name], value, err_msg=name)


def test_fit_on_mesh_with_checkpoints(setup):
    payload, _, ranks = setup
    hist = ranks[0]["fit_hist"]
    assert hist["loss"] and hist["eval_loss"]
    assert len(hist["eval_loss"]) == 3
    assert hist["loss"][-1] < hist["loss"][0] * 1.5
    for rank in ranks[1:]:
        assert rank["fit_hist"] == hist
        for name, value in ranks[0]["fit_params"].items():
            np.testing.assert_array_equal(rank["fit_params"][name], value)
    # rank 0 alone writes a checkpoint a epoch; the last restores exactly
    assert ranks[0]["fit_written"] == ["ck_e0.npz", "ck_e1.npz", "ck_e2.npz"]
    assert all(rank["fit_written"] == [] for rank in ranks[1:])
    assert ranks[0]["files"] == ["ck_e0.npz", "ck_e1.npz", "ck_e2.npz"]
    assert ranks[0]["restored_equal"]
    # one process's fit on the global batches
    model = tm.hexcnn_tiny(norm=None, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["sd_none"].items()})
    _, single = tm.fit(model, payload["batches"], num_epochs=3,
                       eval_data=payload["batches"][:1], log_every=2)
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(hist[key], single[key], rtol=1e-4)


def test_host_local_batch_slice(setup):
    _, _, ranks = setup
    assert [r["local_slice"] for r in ranks] == [
        slice(8 * i, 8 * i + 8) for i in range(4)]
    assert host_local_batch_slice(32) == slice(0, 32)   # no process group
