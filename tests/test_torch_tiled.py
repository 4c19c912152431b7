"""The port's streaming tiled resample against hygrid_tpu's tiled functions
and the port's monolithic geometry ops.

All three kinds, with ``tile_rows`` that do not divide the output: float32
results within 1e-6 relative of the reference (the blend's summation order
may differ) and bit-equal to the port's monolithic op (the same weights in
the same order); integer sources as the reference returns them (float32
blends, the source dtype through an exact-select plan).  Each rect->hex
bilinear tile keeps its rows' slice of the plan's factors, so its kernel
tables are factored like the whole plan's.
"""
import numpy as np
import pytest

from hygrid_tpu.ops import tiled as jtiled
from hygrid_tpu_torch.kernels import resample
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.ops import geometry, tiled

TOL = 1e-6


def _rel(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


# (kind, source shape, dsize, interpolation, tile_rows, monolithic op)
CASES = [
    ("rect_to_hex", (3, 64, 48), (32, 24), "bilinear", 5,
     "rect_to_hex_resample"),
    ("rect_to_hex", (2, 41, 37), (27, 30), "nearest", 8,
     "rect_to_hex_resample"),
    ("hexresize", (2, 40, 30), (25, 19), "linear", 4, "hexresize"),
    ("hex_to_rect", (2, 30, 30), (41, 37), "linear", 7,
     "hex_to_rect_resample"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_tiled_matches_jax_and_monolithic(case):
    kind, shape, dsize, interp, rows, op = case
    img = np.random.default_rng(len(shape) + rows).random(shape).astype(
        np.float32)
    want = jtiled.tiled_resample(img, kind, dsize, interp, tile_rows=rows)
    got = tiled.tiled_resample(img, kind, dsize, interp, tile_rows=rows,
                               device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape and _rel(got, want) <= TOL
    mono = getattr(geometry, op)(img, dsize, interp, device="cpu").numpy()
    assert np.array_equal(got, mono)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", ["uint16", "uint8", "int32"])
def test_tiled_integer_sources_match_jax(dtype, interp):
    rng = np.random.default_rng(1)
    img = (rng.random((4, 50, 40)) * 250).astype(dtype)
    want = jtiled.tiled_rect_to_hex(img, (25, 20), interp, tile_rows=7)
    got = tiled.tiled_rect_to_hex(img, (25, 20), interp, tile_rows=7,
                                  device="cpu")
    assert got.dtype == want.dtype
    if interp == "nearest":
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL


def test_tiled_2d_source_and_memmap(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.random((33, 29)).astype(np.float32)
    mm = np.memmap(tmp_path / "src.raw", np.float32, "w+", shape=img.shape)
    mm[:] = img
    want = jtiled.tiled_hexresize(img, (20, 21), tile_rows=6)
    got = tiled.tiled_hexresize(mm, (20, 21), tile_rows=6, device="cpu")
    assert got.shape == (1, 20, 21) and _rel(got, want) <= TOL
    with pytest.raises(ValueError):
        tiled.tiled_resample(img, "warp", (5, 5), device="cpu")


def test_tile_sub_plans_keep_factored_tables():
    plan = geometry.rect_to_hex_plan(64, 48, 32, 24, "bilinear")
    for r0, r1 in [(0, 5), (5, 10), (7, 8), (10, 32)]:
        lo, hi, sub = plan.row_slice(r0, r1)
        assert sub.src_shape == (hi - lo + 1, 48)
        assert np.array_equal(sub.idx + lo * 48, plan.idx[:, r0:r1])
        tables = resample.gather_tables(sub, 4)
        assert (tables.index_form, tables.weight_form) == ("parity",
                                                           "factored")
        idx, weights = tables.expand()
        assert np.array_equal(idx, sub.idx)
        assert np.array_equal(weights.view(np.uint32),
                              sub.weights.view(np.uint32))


def test_tiled_on_cpu_counts_no_launch():
    before = counts().get("plan_gather", 0)
    tiled.tiled_rect_to_hex(np.ones((1, 16, 16), np.float32), (8, 8),
                            tile_rows=3, device="cpu")
    assert counts().get("plan_gather", 0) == before


@pytest.mark.parametrize("kind", ["hexresize", "rect_to_hex_nearest"])
def test_row_slices_rebuild_the_plan(kind):
    """Each tile's band and sub-plan, run by the plain gather, give back
    the whole plan's rows; a plan without rect->hex factors gives tiles
    without them."""
    import torch
    from hygrid_tpu_torch.ops import sampling
    if kind == "hexresize":
        plan = geometry.hexresize_plan(31, 27, 23, 35, "linear")
    else:
        plan = geometry.rect_to_hex_plan(31, 27, 17, 14, "nearest")
    img = torch.from_numpy(np.random.default_rng(3).random(
        (2, 31, 27)).astype(np.float32))
    want = sampling.apply_plan(img, plan)
    h1 = plan.out_shape[0]
    for r0 in range(0, h1, 6):
        r1 = min(r0 + 6, h1)
        lo, hi, sub = plan.row_slice(r0, r1)
        assert "rect_factors" not in sub._derived
        got = sampling.apply_plan(img[:, lo:hi + 1], sub)
        assert torch.equal(got, want[:, r0:r1])
