"""The port's hex augmentation against hygrid_tpu.

The transforms are permutations with zero fill, so at given parameters they
are bit-equal to the reference's: ``hexrot60_same`` at every k (and one k
per image of a batch), the flips and the translation.  The random wrappers
draw from a ``torch.Generator``, not a JAX key, so they are held to what
their draws must give: each output is one of the 12 dihedral images of its
input (shifted, with even row shifts only, zero fill), p=0 and p=1 flips,
and replaying :func:`augment_draws` gives the same batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.ops import augment as jaug
from hygrid_tpu_torch.ops import augment as taug
import hygrid_tpu_torch as pt


def _batch(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.3) * 200).astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    if got.dtype.kind == "f":      # -0.0 where the reference has it
        assert np.array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("dtype,shape,pivot", [
    ("float32", (3, 2, 9, 12), None), ("uint8", (4, 11, 7), (2, 3)),
    ("int32", (2, 10, 10), (0, 0))])
def test_hexrot60_same_matches_jax(dtype, shape, pivot):
    x = _batch(shape, dtype)
    for k in range(-1, 7):
        _same(taug.hexrot60_same(x, k, pivot, device="cpu"),
              jaug.hexrot60_same(x, k, pivot))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_hexrot60_same_per_image_k_matches_jax(dtype):
    x = _batch((6, 3, 8, 9), dtype, seed=1)
    ks = np.array([0, 1, 2, 3, 4, 5])
    want = jax.vmap(lambda a, k: jaug.hexrot60_same(a, k))(x, ks)
    _same(taug.hexrot60_same(torch.from_numpy(x), torch.from_numpy(ks)),
          want)
    with pytest.raises(ValueError):
        taug.hexrot60_same(torch.from_numpy(x), torch.zeros(4, dtype=int))


@pytest.mark.parametrize("axis", ["horizontal", "vertical"])
def test_flip_where_matches_jax(axis):
    """hexflip_where at a given mask against the reference's flip rule
    (random_hexflip with p=1 is the flipped batch, p=0 the input)."""
    x = _batch((4, 2, 7, 9), "float32", seed=2)
    key = jax.random.PRNGKey(0)
    flipped = jaug.random_hexflip(key, x, p=1.0, axis=axis)
    mask = np.array([True, False, True, False])
    want = np.where(mask[:, None, None, None], np.asarray(flipped), x)
    _same(taug.hexflip_where(x, mask, axis, device="cpu"), want)
    _same(taug.hexflip_where(x, np.ones(4, bool), axis, device="cpu"),
          flipped)


def _jax_translate(x, dy, dx):
    """hygrid_tpu's random_hex_translate at given shifts: its per-image
    body under the reference's own vmap."""
    def shift_one(img, dy, dx):
        zero = jnp.zeros((), img.dtype)
        h, w = img.shape[-2:]
        rows = jnp.arange(h)[:, None] - dy
        cols = jnp.arange(w)[None, :] - dx
        valid = ((rows >= 0) & (rows < h) & (cols >= 0) & (cols < w))
        g = img[..., jnp.clip(rows, 0, h - 1).squeeze(-1), :][
            ..., :, jnp.clip(cols, 0, w - 1).squeeze(0)]
        return jnp.where(valid, g, zero)
    return jax.vmap(shift_one)(x, dy, dx)


@pytest.mark.parametrize("dtype,shape", [("float32", (5, 3, 10, 8)),
                                         ("uint8", (5, 9, 11))])
def test_translate_matches_jax(dtype, shape):
    x = _batch(shape, dtype, seed=3)
    dy = np.array([-4, -2, 0, 2, 12])
    dx = np.array([2, -1, 0, 3, -20])
    _same(taug.hex_translate(x, dy, dx, device="cpu"),
          _jax_translate(x, dy, dx))
    # the reference's draws at its own key, replayed
    key = jax.random.PRNGKey(7)
    kr, kc = jax.random.split(key)
    jdy = 2 * jax.random.randint(kr, (shape[0],), -2, 3)
    jdx = jax.random.randint(kc, (shape[0],), -2, 3)
    _same(taug.hex_translate(x, np.array(jdy), np.array(jdx),
                             device="cpu"),
          jaug.random_hex_translate(key, x, 2))


def _orbit(x):
    """The 12 dihedral images of each image of ``x`` (B, C, H, W) on the
    same canvas: (12, B, C, H, W)."""
    rots = [taug.hexrot60_same(x, k) for k in range(6)]
    return torch.stack(rots + [torch.flip(r, dims=(-1,)) for r in rots])


def test_augment_hex_batch_is_in_the_dihedral_orbit():
    x = torch.from_numpy(_batch((8, 3, 12, 14), "float32", seed=4))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    out = pt.augment_hex_batch(gen, x, rotate=True, flip=True, translate=2)
    gen.set_state(state)
    draws = taug.augment_draws(gen, 8, rotate=True, flip=True, translate=2)
    assert torch.equal(taug.apply_augment(x, draws), out)
    assert set(draws) == {"k", "flip", "dy", "dx"}
    assert (draws["dy"] % 2 == 0).all() and draws["dy"].abs().max() <= 4
    assert draws["dx"].abs().max() <= 2
    cands = taug.hex_translate(_orbit(x).flatten(0, 1),
                               draws["dy"].repeat(12), draws["dx"].repeat(12))
    cands = cands.reshape((12,) + tuple(x.shape))
    hits = (cands == out[None]).flatten(2).all(-1)          # (12, B)
    assert hits.any(0).all()
    # with no translation the output is exactly an orbit member
    gen.manual_seed(1)
    out = taug.augment_hex_batch(gen, x)
    assert (_orbit(x) == out[None]).flatten(2).all(-1).any(0).all()


def test_random_wrappers():
    x = torch.from_numpy(_batch((16, 2, 10, 10), "uint8", seed=5))
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(taug.random_hexflip(gen, x, p=0.0), x)
    assert torch.equal(taug.random_hexflip(gen, x, p=1.0),
                       torch.flip(x, dims=(-1,)))
    rot = taug.random_hexrot60(gen, x)
    assert rot.dtype == x.dtype and rot.shape == x.shape
    assert (_orbit(x)[:6] == rot[None]).flatten(2).all(-1).any(0).all()
    shifted = taug.random_hex_translate(gen, torch.ones(64, 1, 9, 9), 3)
    # row shifts are even: the number of zero rows of each image is even
    zero_rows = (shifted[:, 0].sum(-1) == 0).sum(-1)
    assert (zero_rows % 2 == 0).all() and zero_rows.max() <= 6
    assert ((shifted == 0) | (shifted == 1)).all()
    assert (shifted == 0).any() and (zero_rows > 0).any()
