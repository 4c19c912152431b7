"""The plan-gather kernel's tables and block schedule, on the CPU.

``csrc/plan_gather.cu`` reads a plan from the tables of
``kernels/resample.py::gather_tables`` ("dense", "rows" or "parity"
indices; "pixel" or "factored" weights) in tiles of 8 output rows by one
warp's 32 x V columns, each tile's source band staged in shared memory.

* The port's row-band decomposition equals ``hygrid_tpu``'s
  (``resample_pallas.rowsep_decompose``) at rect->hex, hex->rect, hexresize
  and same-size (3-phase) plans, field for field.
* Each table form expands bit for bit to ``plan.idx`` and ``plan.weights``;
  the factored form is taken only where the plan's recorded factors
  rebuild its weights exactly (one ulp off is refused).
* The block schedule in plain PyTorch (the band staged as the kernel stages
  it, every other band element NaN; each lane's taps at the offsets the
  kernel forms, summed in k order; ragged rows and columns masked) agrees
  with ``hygrid_tpu.ops.sampling.apply_plan`` in float32 within 1e-6
  absolute (summation order only), at odd h1 and w1 and more than one
  column tile.  Tables are compared exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu import lattice as jlat
from hygrid_tpu.kernels import resample_pallas as jrp
from hygrid_tpu.kernels import resample_shift as jrs
from hygrid_tpu.ops import geometry as jgeo
from hygrid_tpu.ops import sampling as jsamp
from hygrid_tpu_torch.kernels import resample as tres
from hygrid_tpu_torch.ops import geometry as tgeo

TOL = 1e-6

# (kind, method, source, output, hex grid shift) built by the reference's
# own plan functions, for the decomposition
REF_PLANS = {
    "rect2hex-64x64-32x32-bilinear": ("rect", "bilinear", (64, 64), (32, 32),
                                      False),
    "hex2rect-32x32-64x64-linear": ("hex", "linear", (32, 32), (64, 64),
                                    False),
    "hexresize-31x27-20x41-linear": ("resize", "linear", (31, 27), (20, 41),
                                     False),
    "same-size-64x64-linear": ("hex", "linear", (64, 64), (64, 64), False),
}


def _ref_plan(kind, method, src, out, shift):
    box = {"rect": "rect_source", "hex": "hex_to_rect",
           "resize": "hexresize"}[kind]
    gx, gy = jgeo._linspace_grid(jlat.corner_box(box, *src), *out, shift)
    if kind == "rect":
        return jsamp.rect_sample_plan(gx, gy, *src, method)
    return jsamp.hex_sample_plan(gx, gy, *src, method)


def _port(ref):
    return tgeo.sampling.SamplePlan(
        np.asarray(ref.idx), np.asarray(ref.weights), tuple(ref.src_shape),
        tuple(ref.out_shape), ref.exact_select)


@pytest.mark.parametrize("name", list(REF_PLANS))
def test_rowsep_decompose_matches_the_reference(name):
    ref = _ref_plan(*REF_PLANS[name])
    want = jrp.rowsep_decompose(ref)
    got = tres.rowsep_decompose(_port(ref))
    assert want is not None and got is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_same_size_plan_has_three_row_phases():
    """The same-size plan is the TPU's phased kind (#3): the reference finds
    three row phases in it."""
    ref = _ref_plan(*REF_PLANS["same-size-64x64-linear"])
    assert jrs.shift_decompose(ref).n_phases == 3


# the port's plans, one of each form, with odd h1 and w1 and (f32 and bf16
# tiles) more than one column tile
def _plans():
    return {
        "parity-factored": tgeo.rect_to_hex_plan(40, 600, 21, 301, "bilinear",
                                                 hex_grid_shift=True),
        "rows-pixel": tgeo.hex_to_rect_plan(20, 150, 37, 299, "linear"),
        "parity-pixel": tgeo.hex_to_rect_plan(27, 270, 27, 270, "linear"),
        "parity-pixel-nearest": tgeo.rect_to_hex_plan(61, 47, 30, 25,
                                                      "nearest"),
        "dense-pixel": tgeo.warp_plan(
            37, 21, [[0.9, 0.3, 1.0], [-0.2, 1.1, -2.0], [0, 0, 1]],
            "linear"),
    }


FORMS = list(_plans())


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("form", FORMS)
def test_each_table_form_expands_to_the_plan_bit_for_bit(form, esz):
    plan = _plans()[form]
    tables = tres.gather_tables(plan, esz)
    assert form.startswith(f"{tables.index_form}-{tables.weight_form}")
    idx, weights = tables.expand()
    assert idx.dtype == np.int32 and np.array_equal(idx, plan.idx)
    assert np.array_equal(weights.view(np.uint32),
                          plan.weights.view(np.uint32))
    # the compact forms are smaller than the dense plan
    dense = plan.idx.nbytes + plan.weights.nbytes
    if tables.weight_form == "factored":
        assert tables.table_bytes * 4 < dense


def _altered(plan, name, where, value):
    f = plan._derived["rect_factors"]
    bad = {**f, name: f[name].copy()}
    bad[name][where] = value
    return dataclasses.replace(plan, _device_copies={},
                               _derived={"rect_factors": bad})


@pytest.mark.parametrize("name,where", [("row", (5, 1)), ("col", (1, 10, 0)),
                                        ("row_valid", (7, 0))])
def test_factors_one_ulp_off_are_refused(name, where):
    """A factor one float32 ulp off (or a validity flipped) changes some
    weight, and the table falls back to the plan's float32 weights; a
    float64 ulp that no weight sees keeps the factored form, which is then
    still exact."""
    plan = tgeo.rect_to_hex_plan(64, 96, 31, 47, "bilinear",
                                 hex_grid_shift=True)
    assert tres.gather_tables(plan, 2).weight_form == "factored"
    v = plan._derived["rect_factors"][name][where]
    up32 = float(np.nextafter(np.float32(v), np.float32(2)))
    altered = _altered(plan, name, where, 1.0 - v if "valid" in name else up32)
    tables = tres.gather_tables(altered, 2)
    assert (tables.index_form, tables.weight_form) == ("parity", "pixel")
    up64 = _altered(plan, name, where, np.nextafter(v, 2.0))
    tables = tres.gather_tables(up64, 4)
    if tables.weight_form == "factored":
        assert np.array_equal(tables.expand()[1].view(np.uint32),
                              plan.weights.view(np.uint32))
    # a plan with no recorded factors keeps its float32 weights
    bare = dataclasses.replace(plan, _device_copies={}, _derived={})
    assert tres.gather_tables(bare, 4).weight_form == "pixel"
    assert tres.gather_tables(plan, 4, factored=False).weight_form == "pixel"


def test_non_rect_plans_record_no_factors():
    assert "rect_factors" not in tgeo.hex_to_rect_plan(
        20, 150, 37, 299, "linear")._derived
    assert "rect_factors" not in tgeo.rect_to_hex_plan(
        61, 47, 30, 25, "nearest")._derived


def _schedule(x: torch.Tensor, tables) -> torch.Tensor:
    """The kernel's block schedule in plain PyTorch, float32: ``x`` (N, H, W)
    -> (N, h1, w1)."""
    k, h1, w1, h, w = tables.shape
    esz = tables.esz
    seg, ch = tres.tile_width(esz), 16 // esz
    n_rt, n_ct = -(-h1 // tres.TILE_ROWS), -(-w1 // seg)
    n = x.shape[0]
    out = torch.full((n, h1, w1), float("nan"))
    lane_cols = np.arange(seg)
    for rt in range(n_rt):
        rows = np.arange(rt * tres.TILE_ROWS,
                         min((rt + 1) * tres.TILE_ROWS, h1))
        for ct in range(n_ct):
            cols = ct * seg + lane_cols
            cols = cols[cols < w1]                    # the masked tail
            r2, c2 = np.meshgrid(rows, cols, indexing="ij")
            if tables.index_form == "dense":
                band = x.reshape(n, -1)
                off = tables.idx.reshape(k, h1, w1)[:, r2, c2].astype(np.int64)
            else:
                row_lo = int(tables.tile_row_lo[rt])
                col_lo = int(tables.tile_col_lo[rt, ct])
                pitch = tables.band_pitch
                assert col_lo % ch == 0 and pitch % ch == 0
                staged = torch.full((n, tables.band_rows, pitch),
                                    float("nan"))
                rr = min(h, row_lo + tables.band_rows) - row_lo
                cc = min(w, col_lo + pitch) - col_lo
                staged[:, :rr, :cc] = x[:, row_lo:row_lo + rr,
                                        col_lo:col_lo + cc]
                band = staged.reshape(n, -1)
                rb = (tables.rowbase[r2].astype(np.int64) - row_lo) * pitch
                if tables.index_form == "rows":
                    e = tables.idx.reshape(k, h1, w1)[:, r2, c2].view(
                        np.uint16).astype(np.int64)
                    off = rb[None] + (e & 1) * pitch + (e >> 1)
                else:
                    col = tables.idx[:, r2 % 2, c2].astype(np.int64)
                    d = tables.dk[:, r2].astype(np.int64)
                    off = rb[None] + d * pitch + col
            if tables.weight_form == "factored":
                cf = tables.colf[r2 % 2, :, c2]              # (R, C, 4)
                rf = tables.rowf[r2]
                wts = np.stack([((cf[..., kk & 1] * rf[..., kk >> 1])
                                 * (rf[..., 2 + (kk >> 1)]
                                    * cf[..., 2 + (kk & 1)])
                                 ).astype(np.float32) for kk in range(k)])
            else:
                wts = tables.weights.reshape(k, h1, w1)[:, r2, c2]
            acc = torch.zeros((n,) + r2.shape)
            for kk in range(k):                       # the plan's k order
                taps = band[:, torch.from_numpy(off[kk].reshape(-1))]
                acc = acc + torch.from_numpy(wts[kk]) * taps.reshape(acc.shape)
            out[:, r2, c2] = acc
    return out


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("form", FORMS)
def test_block_schedule_matches_the_reference_apply_plan(form, esz):
    plan = _plans()[form]
    tables = tres.gather_tables(plan, esz)
    x = np.random.default_rng(7).random((3,) + plan.src_shape,
                                        dtype=np.float32)
    got = _schedule(torch.from_numpy(x), tables).numpy()
    ref_plan = jsamp.SamplePlan(plan.idx, plan.weights, plan.src_shape,
                                tuple(plan.out_shape), plan.exact_select)
    want = np.asarray(jsamp.apply_plan(jnp.asarray(x), ref_plan))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL
