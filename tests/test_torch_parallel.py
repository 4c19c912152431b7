"""The port's ``parallel`` package (halo exchange, row-sharded hex conv and
resample, the GPipe pipeline) on a 4-rank gloo world, against
``hygrid_tpu.parallel`` on the 8 virtual CPU devices of ``conftest.py``.

One world runs every case (``torch_ranks.parallel_world``); each rank
returns its slabs, which the tests reassemble.  Float32 throughout.
Tolerances, as the reference's own tests hold its sharded ops: the halo
exchange and its gradient exact; the conv within 1e-5 of the reference's
sharded and unsharded conv; the resample within 1e-6 (the canonical lift
bit-equal to the port's monolithic plan); the pipeline bit-equal to the
port's sequential stack on the same microbatches and within 1e-5 of the
reference's, its grads
rtol 1e-4 / atol 1e-5 of ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hygrid_tpu as hg
from hygrid_tpu import parallel as jpar
from hygrid_tpu.nn import functional as JF
from hygrid_tpu.parallel.spatial import shard_map
import hygrid_tpu_torch as tg
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.parallel import spatial as tspatial
import torch_ranks as tr

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return tr.run_world("parallel_world", WORLD)


def _assemble(ranks, key, axes, rows=None, cols=None):
    """Glue the ranks' slabs of ``key`` back together.  ``axes`` is the
    mesh: ``{"sp": 4}`` (rank = row slab), ``{"dp": 2, "sp": 2}`` (ranks
    0-1 hold the row slabs), ``{"spr": 2, "spc": 2}`` (rank = 2 row + col);
    then crop to ``rows`` / ``cols``."""
    if "spr" in axes:
        full = np.concatenate([np.concatenate(
            [ranks[2 * i + j][key] for j in range(2)], -1) for i in range(2)],
            -2)
    else:
        n = axes["sp"]
        full = np.concatenate([ranks[i][key] for i in range(n)], -2)
    return full[..., :rows or full.shape[-2], :cols or full.shape[-1]]


def test_halo_exchange_matches_reference(ranks):
    mesh = jpar.create_mesh({"sp": 4})
    spec = jpar.P(None, None, "sp", None)
    want = np.asarray(shard_map(
        lambda b: jpar.halo_exchange(b, 2, 2, "sp"), mesh=mesh,
        in_specs=(spec,), out_specs=spec)(jnp.asarray(tr.halo_input())))
    got = _assemble(ranks, "halo", {"sp": 4})
    np.testing.assert_array_equal(got, want)
    blocks = got.reshape(4, 12)
    np.testing.assert_array_equal(blocks[1], np.arange(6, 18))
    np.testing.assert_array_equal(blocks[0][:2], 0)
    np.testing.assert_array_equal(blocks[3][-2:], 0)


def test_halo_exchange_grad_matches_reference(ranks):
    mesh = jpar.create_mesh({"sp": 4})
    spec = jpar.P(None, None, "sp", None)
    w = jnp.asarray(np.concatenate(list(tr.halo_weights()), -2))
    f = shard_map(lambda b: jpar.halo_exchange(b, 2, 2, "sp"), mesh=mesh,
                  in_specs=(spec,), out_specs=spec)
    want = np.asarray(jax.grad(lambda x: jnp.sum(f(x) * w))(
        jnp.asarray(tr.halo_input())))
    np.testing.assert_array_equal(_assemble(ranks, "halo_grad", {"sp": 4}),
                                  want)


@pytest.mark.parametrize("case", list(tr.CONV_CASES))
def test_sharded_hex_conv_matches_reference(ranks, case):
    _, shape, _, radius, offset, axes = tr.CONV_CASES[case]
    x, k, k2 = tr.conv_input(case)
    h, w = shape[-2:]
    got = _assemble(ranks, f"conv_{case}", axes)
    assert not got[..., h:, :].any() and not got[..., :, w:].any()
    got = got[..., :h, :w]
    names = list(axes)
    kw = dict(axis_name=names[0],
              col_axis_name=names[1] if len(names) > 1 else None)
    mesh = jpar.create_mesh(axes)
    sharded = np.asarray(jpar.sharded_hex_conv2d(
        jnp.asarray(x), jnp.asarray(k), mesh, even_odd_offset=offset,
        radius=radius, **kw))
    unsharded = np.asarray(JF.hex_conv2d(x, k, even_odd_offset=offset,
                                         radius=radius, padding=radius - 1))
    np.testing.assert_allclose(got, sharded, atol=1e-5)
    np.testing.assert_allclose(got, unsharded, atol=1e-5)
    if case == "sp4_rows30":
        chain = _assemble(ranks, f"conv_{case}_chain", axes)
        assert not chain[..., h:, :].any()
        want = np.asarray(JF.hex_conv2d(unsharded, k2, radius=radius,
                                        padding=radius - 1))
        np.testing.assert_allclose(chain[..., :h, :], want, atol=1e-5)


def _ref_resample(kind):
    return {"rect_to_hex": hg.rect_to_hex_resample, "hexresize": hg.hexresize,
            "hex_to_rect": hg.hex_to_rect_resample}[kind]


@pytest.mark.parametrize("case", list(tr.RESAMPLE_CASES))
def test_sharded_resample_matches_reference(ranks, case):
    _, kind, dsize, interp, shape, axes, names = tr.RESAMPLE_CASES[case]
    x = tr.resample_input(case)
    full = _assemble(ranks, f"resample_{case}", axes)
    got = full[..., :dsize[0], :dsize[1]]
    assert not full[..., dsize[0]:, :].any()
    assert not full[..., :, dsize[1]:].any()
    ref_axes = {k: v for k, v in axes.items() if k != "dp"}
    sharded = np.asarray(jpar.sharded_resample(
        jnp.asarray(x), jpar.create_mesh(ref_axes), kind, dsize, interp,
        axis_name=names[0], col_axis_name=names[1]))
    monolithic = np.asarray(_ref_resample(kind)(x, dsize, interp))
    assert got.shape == monolithic.shape
    np.testing.assert_allclose(got, sharded, atol=1e-6)
    np.testing.assert_allclose(got, monolithic, atol=1e-6)


def test_canonical_lift_is_bit_equal_to_monolithic(ranks):
    got = _assemble(ranks, "resample_r2h_nearest", {"sp": 4})
    np.testing.assert_array_equal(got, ranks[0]["monolithic_r2h_nearest"])
    # odd output slabs alternate the hex row parity: two plans
    assert ranks[0]["groups_parity_sp2"] == 2


def test_resample_errors(ranks):
    assert all(r["err_max_groups"] == "ValueError" for r in ranks)
    assert all(r["err_halo"] == "ValueError" for r in ranks)
    x = jnp.asarray(tr.resample_input("parity_sp2"))
    with pytest.raises(ValueError, match="max_groups"):
        jpar.sharded_resample(x, jpar.create_mesh({"sp": 2}), "rect_to_hex",
                              (18, 12), "bilinear", max_groups=1)
    with pytest.raises(ValueError, match="halos"):
        jpar.sharded_resample(jnp.zeros((1, 3, 64, 48)),
                              jpar.create_mesh({"sp": 4}), "hexresize",
                              (5, 4), "linear")
    with pytest.raises(ValueError, match="halos"):
        tspatial.shard_plans("hexresize", (64, 48), (5, 4), "linear", 4)


def test_halo_path_sends_halos_only(ranks):
    """Row-sharded resample, 4 convs and the resample back: only send/recv
    of halo rows, no all-reduce or broadcast (the counterpart of the
    reference's HLO census), and the monolithic chain's result."""
    for r in ranks:
        c = r["census"]
        assert c["all_reduce"] == 0 and c["broadcast"] == 0, c
        assert c["send"] == c["recv"] > 0, c
    assert sum(r["census"]["send"] for r in ranks) >= 8
    x, kerns = tr.census_input()
    h = tg.rect_to_hex_resample(torch.from_numpy(x), (32, 64), "bilinear")
    for k in kerns:
        h = TF.hex_conv2d(h, torch.from_numpy(k), radius=2, padding=1)
    want = tg.hex_to_rect_resample(h, (64, 64), "linear").numpy()
    np.testing.assert_allclose(_assemble(ranks, "census_out", {"sp": 4}),
                               want, atol=1e-5)


def _ref_sequential(x, ks, r, act=None):
    h = jnp.asarray(x)
    for i in range(ks.shape[0]):
        h = JF.hex_conv2d(h, ks[i], even_odd_offset=0, radius=r,
                          padding=r - 1)
        h = act(h) if act is not None else h
    return h


def test_pipeline_matches_sequential(ranks):
    ks, x, r = tr.pipeline_stack()
    want = np.asarray(jpar.pipeline_hex_conv_stack(
        jnp.asarray(x), jnp.asarray(ks), jpar.create_mesh({"pp": 4}),
        radius=r, microbatches=4))
    for rank in ranks:
        np.testing.assert_array_equal(rank["pipe"], rank["pipe_seq"])
        np.testing.assert_allclose(rank["pipe"], want, atol=1e-5)


def test_pipeline_activation_and_more_microbatches(ranks):
    ks, x, r = tr.pipeline_stack()
    want = np.asarray(jpar.pipeline_hex_conv_stack(
        jnp.asarray(x), jnp.asarray(ks), jpar.create_mesh({"pp": 2}),
        radius=r, microbatches=8, activation=jax.nn.relu))
    for rank in ranks:
        np.testing.assert_array_equal(rank["pipe_relu"],
                                      rank["pipe_relu_seq"])
        np.testing.assert_allclose(rank["pipe_relu"], want, atol=1e-5)


def test_pipeline_gradients_match_reference(ranks):
    ks = tr.pipeline_stack(L=4)[0]
    _, x, r = tr.pipeline_stack()
    mesh = jpar.create_mesh({"pp": 4})
    want = np.asarray(jax.grad(lambda k: jnp.sum(jpar.pipeline_hex_conv_stack(
        jnp.asarray(x), k, mesh, radius=r, microbatches=4) ** 2))(
            jnp.asarray(ks)))
    want_seq = np.asarray(jax.grad(
        lambda k: jnp.sum(_ref_sequential(x, k, r) ** 2))(jnp.asarray(ks)))
    # each rank holds its own stage's slice (one layer a stage)
    got = np.stack([ranks[s]["pipe_grad"][s] for s in range(4)])
    for s in range(4):
        others = np.delete(ranks[s]["pipe_grad"], s, axis=0)
        assert not others.any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want_seq, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ranks[0]["pipe_grad_seq"], rtol=1e-4,
                               atol=1e-5)


def test_generic_pipeline_apply(ranks):
    stages, x = tr.generic_stages()
    params = jpar.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    want = np.asarray(jpar.pipeline_apply(
        lambda p, xm: jnp.tanh(xm @ p["w"] + p["b"]), params, jnp.asarray(x),
        jpar.create_mesh({"pp": 4}), microbatches=4))
    seq = x
    for s in stages:
        seq = np.tanh(seq @ s["w"] + s["b"])
    for rank in ranks:
        np.testing.assert_allclose(rank["pipe_generic"], want, atol=1e-6)
        np.testing.assert_allclose(rank["pipe_generic"], seq, atol=1e-5)


def test_pipeline_rejects_bad_configs(ranks):
    # 6 layers over 4 stages; fewer microbatches than stages; a nonzero
    # offset; a batch that microbatches do not split
    for rank in ranks:
        assert rank["pipe_errors"] == ["ValueError"] * 4


def test_pipeline_parallel_training_decreases_loss(ranks):
    losses = ranks[0]["pipe_train_losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for rank in ranks[1:]:   # the loss is replicated over the stages
        assert rank["pipe_train_losses"] == losses
