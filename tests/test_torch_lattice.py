"""The port's numpy lattice copy equals hygrid_tpu.lattice on random inputs."""
import numpy as np
import pytest

from hygrid_tpu import lattice as jl
from hygrid_tpu_torch import lattice as tl


def _coords(seed, n=200):
    rng = np.random.default_rng(seed)
    return rng.uniform(-40, 40, n), rng.uniform(-40, 40, n)


def test_public_names_match():
    assert tl.__all__ == jl.__all__


@pytest.mark.parametrize("offset", [0, 1])
def test_row_is_shifted(offset):
    i = np.random.default_rng(0).integers(-50, 50, 100)
    np.testing.assert_array_equal(tl.row_is_shifted(i, offset),
                                  jl.row_is_shifted(i, offset))


@pytest.mark.parametrize("h,w,offset", [(7, 5, 0), (8, 9, 1), (1, 12, 0)])
def test_cell_centers(h, w, offset):
    for a, b in zip(tl.cell_centers(h, w, offset), jl.cell_centers(h, w, offset)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", [(17, 13), (512, 512), (9, 4)])
def test_affine_index(h, w):
    x, y = _coords(1)
    for a, b in zip(tl.affine_index(x, y, h, w), jl.affine_index(x, y, h, w)):
        np.testing.assert_array_equal(a, b)


def test_trunc_helpers():
    a = np.random.default_rng(2).uniform(-9, 9, 300)
    np.testing.assert_array_equal(tl._trunc_int(a, np), jl._trunc_int(a, np))
    np.testing.assert_array_equal(tl._trunc_div2(a, np), jl._trunc_div2(a, np))


def test_hex_neighbors():
    rng = np.random.default_rng(3)
    i, j = rng.integers(-20, 20, 300), rng.integers(-20, 20, 300)
    for a, b in zip(tl.hex_neighbors(i, j), jl.hex_neighbors(i, j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _triangle(mod, seed):
    x, y = _coords(seed)
    i_, j_ = mod.affine_index(x, y, 23, 17)
    i_n, j_n = mod._trunc_int(i_, np), mod._trunc_int(j_, np)
    return x, y, mod.triangle_vertices(i_n, j_n, i_ - i_n, j_ - j_n, 23, 17)


def test_triangle_vertices():
    _, _, a = _triangle(tl, 4)
    _, _, b = _triangle(jl, 4)
    np.testing.assert_array_equal(a[0], b[0])
    for pa, pb in zip(a[1:], b[1:]):
        for ca, cb in zip(pa, pb):
            np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("fn", ["triangle_weights_linear",
                                "triangle_select_nearest"])
def test_triangle_blend(fn):
    x, y, (_, p1, p2, p3) = _triangle(jl, 5)
    a = getattr(tl, fn)(x, y, p1, p2, p3)
    b = getattr(jl, fn)(x, y, p1, p2, p3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["warp", "hexresize", "hex_to_rect",
                                  "rect_source"])
def test_corner_box(kind):
    for h, w in [(17, 13), (256, 256), (3, 8)]:
        assert tl.corner_box(kind, h, w) == jl.corner_box(kind, h, w)


def test_corner_box_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown corner box"):
        tl.corner_box("nope", 4, 4)


def test_hexspec_padded():
    for h, w, off, pad in [(7, 5, 0, 1), (8, 9, 1, 2), (4, 4, 1, 3)]:
        a = tl.HexSpec(h, w, off).padded(pad)
        b = jl.HexSpec(h, w, off).padded(pad)
        assert (a.height, a.width, a.even_odd_offset) == \
            (b.height, b.width, b.even_odd_offset)
