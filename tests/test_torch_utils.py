"""The port's ``utils`` profiling and checkpoints: ``annotate``,
``device_timer`` and ``benchmark`` as ``tests/test_utils.py`` drives the
reference's; the ``.npz`` round trip of trees and modules (bfloat16 leaves
bit-equal); a ``.npz`` that ``hygrid_tpu.utils.save_checkpoint`` wrote of
``hexcnn_tiny``'s flax variables restored into the port through
``flax_tree_from_npz`` (logits within 1e-4 relative of the reference's);
and the ``torch.save`` round trip of a ``TrainState`` (bit-equal logits,
optimizer state and next step)."""
import jax
import numpy as np
import pytest
import torch

from hygrid_tpu import models as jm
from hygrid_tpu import utils as jutils
from hygrid_tpu_torch import models as tm
from hygrid_tpu_torch import utils
from test_torch_modules import random_flax_variables


def test_annotate_and_timer():
    @utils.annotate("unit-test-op")
    def f(x):
        return x * 2

    with torch.profiler.profile() as prof:
        with utils.device_timer("double") as t:
            t.result = f(torch.ones(8))
    assert t.elapsed >= 0
    assert torch.equal(t.result, torch.full((8,), 2.0))
    assert "unit-test-op" in {e.name for e in prof.events()}
    assert utils.benchmark(f, torch.ones(8), iters=3) >= 0
    assert utils.get_logger().name == "hygrid_tpu_torch"


def test_npz_roundtrip_of_a_tree(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "b": {"c": rng.integers(0, 9, (5,)),
                  "d": torch.randn(2, 2).to(torch.bfloat16)},
            "e": [torch.arange(3), 2.5]}
    path = str(tmp_path / "tree.npz")
    utils.save_checkpoint(path, tree)
    flat = utils.restore_checkpoint(path)
    assert set(flat) == {"['a']", "['b']['c']", "['b']['d']", "['e'][0]",
                         "['e'][1]"}
    back = utils.restore_checkpoint(path[:-4], tree)   # ".npz" implied
    assert torch.equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["d"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["d"], tree["b"]["d"])
    assert torch.equal(back["e"][0], tree["e"][0]) and back["e"][1] == 2.5


def test_npz_roundtrip_of_a_module(tmp_path):
    g = torch.Generator().manual_seed(0)
    model = tm.hexcnn_tiny(norm="BN", device="cpu", generator=g)
    path = str(tmp_path / "model.npz")
    utils.save_checkpoint(path, dict(model.named_parameters()))
    fresh = tm.hexcnn_tiny(norm="BN", device="cpu")
    utils.restore_checkpoint(path, fresh)
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(KeyError):   # a checkpoint of another model
        utils.restore_checkpoint(path, tm.hexcnn_tiny(norm=None,
                                                      device="cpu"))


@pytest.mark.parametrize("what", ["variables", "params"])
def test_reference_npz_restores_into_the_port(tmp_path, what):
    """``what``: the flax variables, or the params alone (what the
    reference's ``fit`` writes)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 16, 16)).astype(np.float32)
    model = jm.hexcnn_tiny(norm="BN")
    variables = random_flax_variables(model, x[:1], 3)
    want = np.asarray(model.apply(variables, x, train=False))
    path = str(tmp_path / "ref.npz")
    jutils.save_checkpoint(path, variables if what == "variables"
                           else variables["params"])
    tree = utils.flax_tree_from_npz(path)
    if what == "params":
        tree = {"params": tree,
                "batch_stats": jax.tree_util.tree_map(
                    np.asarray, variables["batch_stats"])}
    port = tm.hexcnn_tiny(norm="BN", device="cpu")
    port.load_state_dict(utils.hexcnn_state_dict_from_flax(tree))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_flax_tree_from_npz_rejects_other_keys():
    with pytest.raises(ValueError):
        utils.flax_tree_from_npz({"conv.weight": np.zeros(1)})


def test_torch_save_roundtrip_of_a_train_state(tmp_path):
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 3, 16, 16), generator=g)
    y = torch.arange(4) % 10
    state = tm.create_train_state(tm.hexcnn_tiny(norm="BN", device="cpu",
                                                 generator=g))
    tm.train_step(state, x, y)
    path = str(tmp_path / "state.pt")
    utils.save_checkpoint(path, state)
    with pytest.raises(FileExistsError):
        utils.save_checkpoint(path, state)
    utils.save_checkpoint(path, state, force=True)
    other = tm.create_train_state(tm.hexcnn_tiny(norm="BN", device="cpu"))
    restored = utils.restore_checkpoint(path, other)
    assert restored is other and other.step == state.step == 1
    with torch.no_grad():
        assert torch.equal(other.model.eval()(x), state.model.eval()(x))
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, v in sa["state"].items():
        for name, t in v.items():
            assert torch.equal(torch.as_tensor(t),
                               torch.as_tensor(sb["state"][k][name])), name
    # the next step is the same from either
    _, m1 = tm.train_step(state, x, y)
    _, m2 = tm.train_step(other, x, y)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def test_no_orbax():
    assert utils.HAS_ORBAX is False
