"""The host side and the index maths of two redesigned kernels, on the CPU.

The fused stack's bf16 tile (``csrc/hex_conv_fused_stack.cu``,
``fused_stack_mma_kernel``): its packed weights are kernel B's, one slab a
layer, stacked; and the band schedule, written here in plain PyTorch
(each band's input rows staged once a chunk in the tile's 16-byte units,
output row i of the band reading tap (dr, dc) at unit row i + dr - r_lo),
computes hygrid_tpu's conv and, chained, its fused stack (Pallas in
interpret mode).

The shift resampler's compact weight tables
(``resample_shift.shift_decompose``: "select", "phase", "dense"): each
expands bit for bit to the dense ``(h1, n_slots, w1)`` table at the port's
plans, the 4K mosaic's in under 4 MB, and the plain version on a select
table agrees with hygrid_tpu's shift executor.

Tolerances: the band conv in float32 within 1e-5 of max|ref| (summation
order only), with bf16 operands too (inputs and weights rounded on both
sides, products in float32); the chained band stack within 1e-5 of the
reference's fused stack in float32; the shift executor within 1e-5
absolute (as ``test_torch_shift.py`` holds the other forms); tables
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu.kernels import resample_shift as jrs
from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.kernels import resample_shift as trs
from hygrid_tpu_torch.nn import functional as TF
from hygrid_tpu_torch.ops import geometry as tgeo
from hygrid_tpu_torch.ops import sampling as tsamp
from hygrid_tpu_torch.viz import render as trender

REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _round(a):
    """float32 values rounded to bfloat16."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _kernels(seed, c, radius, layers):
    rng = np.random.default_rng(seed)
    kn = TF.hex_kernel_num(radius)
    return [rng.normal(0, 1 / np.sqrt(c * kn), (c, c, kn)).astype(np.float32)
            for _ in range(layers)]


# ---- the fused stack's weights -------------------------------------------

@pytest.mark.parametrize("c,radius", [(16, 2), (32, 3)])
def test_fused_weights_are_kernel_b_slabs_stacked(c, radius):
    """bf16: layer l's slab is _pack_mma_weights of its (kn, Cin, Cout)
    weights, unit [l, chunk, t, g, co] holding input channels 16 chunk +
    8 g .. + 7 of tap t; float32: the (L, kn, C, C) weights."""
    kernels = [torch.from_numpy(k) for k in _kernels(c, c, radius, 3)]
    kn = TF.hex_kernel_num(radius)
    packed = tcs._fused_weights(kernels, torch.bfloat16)
    want = torch.stack([tcs._pack_mma_weights(k.permute(2, 1, 0))
                        for k in kernels])
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (3, -(-c // 16), kn, 2, c, 8)
    assert torch.equal(packed, want)
    for li, k in enumerate(kernels):
        kb = k.bfloat16()                                   # (Cout, Cin, kn)
        for ch in range(c // 16):
            for g in range(2):
                lo = 16 * ch + 8 * g
                # [t, co, 8] = k[co, lo .. lo + 7, t]
                assert torch.equal(packed[li, ch, :, g],
                                   kb[:, lo:lo + 8, :].permute(2, 0, 1))
    f32 = tcs._fused_weights(kernels, torch.float32)
    assert f32.dtype == torch.float32 and tuple(f32.shape) == (3, kn, c, c)
    assert torch.equal(f32, torch.stack([k.permute(2, 1, 0)
                                         for k in kernels]))


# ---- the band schedule in plain PyTorch -------------------------------------

def band_conv(x, wt, radius, rows, bf16):
    """One 'same' conv layer (no bias) as the fused stack's bf16 tile
    computes it: NHWC float32 ``x``, ``wt`` (kn, Cin, Cout); per (sample,
    band of ``rows`` output rows, 64-pixel strip, 16-channel chunk) the
    band's input rows staged once as [row][group][column][8 channels]
    units, and output row i's window of tap (dr, dc) read at unit row
    i + dr - r_lo, column dc - c_lo.  Returns float32 NHWC."""
    x = torch.from_numpy(_round(x) if bf16 else x)
    b, h, w, cin = x.shape
    kn, _, cout = wt.shape
    taps = tcs._taps(radius, 1)
    r_lo, c_lo = int(taps[..., 0].min()), int(taps[..., 1].min())
    n_rows, n_cols = tcs._patch_shape(radius, 1, False)
    chunks = -(-cin // 16)
    if bf16:
        packed = tcs._pack_mma_weights(torch.from_numpy(wt)).float()
    else:
        full = torch.zeros((kn, chunks * 16, cout))
        full[:, :cin] = torch.from_numpy(wt)
        packed = full.view(kn, chunks, 2, 8, cout).permute(1, 0, 2, 4, 3)
    xp = torch.zeros((b, h + 2 * n_rows + rows, w + n_cols + 64,
                      chunks * 16))
    xp[:, n_rows:n_rows + h, n_cols:n_cols + w, :cin] = x
    out = torch.zeros((b, h, w, cout))
    for o0 in range(0, h, rows):
        for w0 in range(0, w, 64):
            acc = torch.zeros((b, rows, 64, cout))
            for ch in range(chunks):
                r0, c0 = n_rows + o0 + r_lo, n_cols + w0 + c_lo
                band = xp[:, r0:r0 + rows + n_rows - 1, c0:c0 + n_cols,
                          16 * ch:16 * ch + 16]
                units = band.reshape(b, rows + n_rows - 1, n_cols, 2, 8) \
                    .permute(0, 1, 3, 2, 4)          # [row][group][col][8]
                for i in range(rows):
                    q = (o0 + i) & 1
                    for t in range(kn):
                        dr, dc = (int(v) for v in taps[q, t])
                        a = units[:, i + dr - r_lo, :, dc - c_lo:dc - c_lo
                                  + 64]              # (b, 2, 64, 8)
                        a = a.permute(0, 2, 1, 3).reshape(b, 64, 16)
                        bm = packed[ch, t].permute(0, 2, 1).reshape(16, cout)
                        acc[:, i] += a @ bm
            n_o, n_w = min(rows, h - o0), min(64, w - w0)
            out[:, o0:o0 + n_o, w0:w0 + n_w] = acc[:, :n_o, :n_w]
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # (B, H, W, C, radius, band rows): the P-512 tile's band, radius 3's,
    # a ragged last band and strip, channels off the 8-channel unit
    (2, 19, 70, 16, 2, 8),
    (1, 11, 20, 32, 3, 4),
    (1, 9, 13, 13, 2, 2),
])
def test_band_conv_matches_hex_conv2d(case, bf16):
    b, h, w, c, radius, rows = case
    rng = np.random.default_rng(h * w + c)
    x = rng.random((b, h, w, c)).astype(np.float32)
    (k,) = _kernels(c + radius, c, radius, 1)
    if bf16:
        x, k = _round(x), _round(k)
    got = band_conv(x, k.transpose(2, 1, 0).copy(), radius, rows, bf16)
    want = JF.hex_conv2d(jnp.asarray(np.moveaxis(x, -1, 1)), jnp.asarray(k),
                         None, even_odd_offset=0, radius=radius,
                         padding=radius - 1, impl="direct")
    assert _rel(got.numpy(), np.moveaxis(np.asarray(want), 1, -1)) <= REL


def test_band_stack_matches_reference_fused_stack():
    """Three layers through band_conv (bias, ReLU between layers, the last
    layer linear) against hex_conv_stack_pallas(fused=True) in interpret
    mode, float32."""
    c, radius, layers = 16, 2, 3
    rng = np.random.default_rng(3)
    x = rng.random((2, c, 12, 18)).astype(np.float32)
    ks = _kernels(5, c, radius, layers)
    bs = [rng.normal(0, 0.1, c).astype(np.float32) for _ in range(layers)]
    want = np.asarray(jcp.hex_conv_stack_pallas(
        x, ks, bs, radius=radius, fused=True, final_activation=False))
    h = np.moveaxis(x, 1, -1).copy()
    for i, (k, bias) in enumerate(zip(ks, bs)):
        y = band_conv(h, k.transpose(2, 1, 0).copy(), radius, 8, False) \
            + torch.from_numpy(bias)
        h = (torch.relu(y) if i < layers - 1 else y).numpy()
    assert _rel(np.moveaxis(h, -1, 1), want) <= REL


# ---- the shift resampler's compact tables -----------------------------------

_SHIFT_PLANS = {
    "mosaic-4k-offset0": lambda: trender._mosaic_sample_plan(
        540, 960, 2160, 3840, 0, None),
    "mosaic-4k-offset1": lambda: trender._mosaic_sample_plan(
        540, 960, 2160, 3840, 1, None),
    "720p-rect-to-hex": lambda: tgeo.rect_to_hex_plan(720, 1280, 360, 640,
                                                      "bilinear"),
    "1080p-rect-to-hex": lambda: tgeo.rect_to_hex_plan(1080, 1920, 540, 960,
                                                       "bilinear"),
    "512-hex-to-rect": lambda: tgeo.hex_to_rect_plan(512, 512, 512, 512,
                                                     "linear"),
}


@pytest.mark.parametrize("name", list(_SHIFT_PLANS))
def test_compact_table_expands_to_the_dense_table(name):
    """The kernel's table, whatever its form, expands to the float32
    (h1, n_slots, w1) table bit for bit; its size is reported."""
    geo = trs.shift_decompose(_SHIFT_PLANS[name]())
    tabs = geo.tensors("cpu")
    full = trs.expand_weights(geo, tabs).numpy()
    want = geo.wplanes.transpose(1, 0, 2)
    assert full.dtype == np.float32 and full.shape == want.shape
    assert np.array_equal(full.view(np.uint32), want.view(np.uint32))
    assert tabs["table_bytes"] == tabs["wtab"].numel() * \
        tabs["wtab"].element_size()
    if name.startswith("mosaic"):
        # 544 phases x 3840 uint8 slot indices, against 199 MB dense
        assert geo.form == "select" and tabs["wtab"].dtype == torch.uint8
        assert tabs["table_bytes"] < 4 * 2 ** 20 < geo.wplanes.nbytes
    else:
        # blends keep the phase or dense table
        assert geo.form == ("phase" if geo.phase_mode else "dense")
        assert geo.table is None


def test_select_table_plain_matches_reference_shift_executor():
    """A nearest-neighbour hex->rect plan (a select table) through the
    plain version, against hygrid_tpu's shift executor in interpret mode
    (1e-5) and apply_plan (bit for bit: one weight of 1 a pixel)."""
    from hygrid_tpu.ops import geometry as jgeo
    from hygrid_tpu import lattice as jlat
    from hygrid_tpu.ops import sampling as jsamp
    gx, gy = jgeo._linspace_grid(jlat.corner_box("hex_to_rect", 48, 64),
                                 48, 64)
    ref = jsamp.hex_sample_plan(gx, gy, 48, 64, "nearest")
    port = tsamp.SamplePlan(np.asarray(ref.idx), np.asarray(ref.weights),
                            (48, 64), (48, 64), ref.exact_select)
    geo = trs.shift_decompose_cached(port)
    assert geo is not None and geo.form == "select"
    x = np.random.default_rng(9).random((2, 48, 64)).astype(np.float32)
    want = np.asarray(jrs.apply_plan_shift(jnp.asarray(x), ref))
    got = trs.shift_resample_plain(torch.from_numpy(x), port)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, tsamp.apply_plan(torch.from_numpy(x), port))
