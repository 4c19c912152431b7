"""The index maths of ``csrc/hex_conv_single.cu``, written in plain numpy
here and held against hygrid_tpu's ``packed_hex_conv_pallas`` (TPU kernels
#7 and #8 in interpret mode on the CPU, as ``tests/test_torch_single_conv.py``
runs them).

float32 (:func:`packed_tile_conv`): the tiles of ``conv_single._f32_plan``,
short output rows of one parity packed into a block's 64 pixels, each
packed row's patch staged side by side through the per-block staging table
(staged column v is column v % ncs of packed row v // ncs), and pixel p of
packed row s reading staged column p + s * (tap width) + the tap's; the
sum in the kernel's order (16-channel chunks, taps, channels).

bfloat16 (:func:`nchw_mma_conv`): kernel B's tensor-core tile staged from
NCHW, one output row's 64 pixels a block: 16-byte units of 8 channels of
one pixel gathered from 8 planes, each tap's A operand the shifted window
of the staged units, K in (chunk, tap, channel) order against the packed
weights of ``conv_stack._pack_mma_weights``.

Tolerances: float32 within 1e-5 absolute (weights scaled so outputs are
O(1); summation order only); bf16 operands (x and the kernel rounded on
both sides, products in float32) within 1e-5 relative.  The host helpers
(the plan, the grid) are checked exactly.
"""
import functools

import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as JP
from hygrid_tpu_torch.kernels import conv_single, conv_stack
from hygrid_tpu_torch.nn import functional as TF

TOL = 1e-5
TILE = 64


def _round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _geometry(table):
    r_lo, c_lo = int(table[..., 0].min()), int(table[..., 1].min())
    n_rows, n_cols = conv_single._patch(table)
    return r_lo, n_rows, c_lo, n_cols


def packed_tile_conv(x, k, parity, radius, dilation):
    """The valid conv of NCHW ``x`` (B, Cin, H, W) by ``k`` (Cout, Cin,
    kn) as the float32 tiles compute it, float32 (B, Cout, Ho, Wo)."""
    b, cin, h, w = x.shape
    cout, _, kn = k.shape
    table = conv_single._valid_taps(radius, dilation, parity)
    r_lo, n_rows, c_lo, n_cols = _geometry(table)
    ho, wo = TF.hex_conv2d_output_shape(h, w, radius, 1, 0, dilation)
    plan = conv_single._f32_plan(b, cin, cout, ho, wo, kn, n_rows, n_cols)
    s_max, sw, ncs, nv = plan["S"], plan["sw"], plan["ncs"], plan["nv"]
    tw = ncs - sw
    per_row = 1 if s_max > 1 else -(-wo // TILE)
    chunks = -(-cin // 16)
    kz = np.zeros((cout, chunks * 16, kn), np.float32)
    kz[:, :cin] = k
    out = np.zeros((b, cout, ho, wo), np.float32)
    n_tiles = 0
    for q in (0, 1):
        nq = (ho + 1 - q) // 2
        rows = b * nq
        tiles = -(-rows // s_max) if s_max > 1 else rows * per_row
        assert tiles == (plan["tiles0"] if q == 0
                         else plan["tiles"] - plan["tiles0"])
        n_tiles += tiles
        for tile in range(tiles):
            if s_max > 1:
                first, n_seg, w0 = tile * s_max, min(s_max, rows - tile
                                                     * s_max), 0
            else:
                first, n_seg, w0 = tile // per_row, 1, tile % per_row * TILE
            # the staging table and the staged patch [n_rows][Cin][nv]
            xs = np.zeros((n_rows, chunks * 16, nv), np.float32)
            for v in range(nv):
                s, c = divmod(v, ncs)
                if s >= n_seg:
                    continue
                bb, kk = divmod(first + s, nq)
                o, gj = q + 2 * kk, w0 + c_lo + c
                for r in range(n_rows):
                    gi = o + r_lo + r
                    if 0 <= gj < w and 0 <= gi < h:
                        xs[r, :cin, v] = x[bb, :, gi, gj]
            p = np.arange(TILE)
            s = p // sw
            live = (s < n_seg) & (w0 + p % sw < wo)
            xoff = np.where(s < n_seg, p + s * tw, 0)
            acc = np.zeros((cout, TILE), np.float32)
            for c0 in range(0, chunks * 16, 16):
                for t in range(kn):
                    dr, dc = (int(v) for v in table[q, t])
                    cols = xs[dr - r_lo, c0:c0 + 16][:, xoff + dc - c_lo]
                    acc += kz[:, c0:c0 + 16, t] @ cols
            for pi in np.flatnonzero(live):
                bb, kk = divmod(first + s[pi], nq)
                out[bb, :, q + 2 * kk, w0 + pi % sw] = acc[:, pi]
    assert n_tiles == plan["tiles"]
    return out


def nchw_mma_conv(x, k, parity, radius, dilation):
    """The valid conv of NCHW ``x`` by ``k`` as the bf16 tile on NCHW
    computes it (on the values given, in float32)."""
    b, cin, h, w = x.shape
    cout, _, kn = k.shape
    table = conv_single._valid_taps(radius, dilation, parity)
    r_lo, n_rows, c_lo, n_cols = _geometry(table)
    ho, wo = TF.hex_conv2d_output_shape(h, w, radius, 1, 0, dilation)
    chunks = -(-cin // 16)
    # (K, Cout) in the kernel's K order from the packed weights
    packed = conv_stack._pack_mma_weights(
        torch.from_numpy(np.ascontiguousarray(k.transpose(2, 1, 0))))
    bmat = packed.permute(0, 1, 2, 4, 3).reshape(-1, cout).float().numpy()
    out = np.zeros((b, cout, ho, wo), np.float32)
    for bb in range(b):
        for o in range(ho):
            q = o & 1
            for w0 in range(0, wo, TILE):
                # units [row][group][column][8 channels], per chunk
                units = np.zeros((chunks, n_rows, 2, n_cols, 8), np.float32)
                for e in range(chunks * n_rows * 2 * n_cols):
                    c = e % n_cols
                    rg = (e // n_cols) % (n_rows * 2)
                    ch = e // (n_cols * n_rows * 2)
                    gi, gj = o + r_lo + rg // 2, w0 + c_lo + c
                    gc = 16 * ch + 8 * (rg & 1)
                    if 0 <= gi < h and 0 <= gj < w:
                        lanes = [x[bb, gc + j, gi, gj] if gc + j < cin
                                 else 0.0 for j in range(8)]
                        units[ch, rg // 2, rg & 1, c] = lanes
                amat = np.zeros((TILE, chunks * kn * 16), np.float32)
                for ch in range(chunks):
                    for t in range(kn):
                        dr, dc = (int(v) for v in table[q, t])
                        win = units[ch, dr - r_lo, :,
                                    dc - c_lo:dc - c_lo + TILE]  # (2, 64, 8)
                        col = (ch * kn + t) * 16
                        amat[:, col:col + 16] = win.transpose(1, 0, 2) \
                            .reshape(TILE, 16)
                res = amat @ bmat                              # (64, Cout)
                n = min(TILE, wo - w0)
                out[bb, :, o, w0:w0 + n] = res[:n].T
    return out


def _inputs(seed, b, cin, cout, h, w, radius, bf16=False):
    rng = np.random.default_rng(seed)
    kn = TF.hex_kernel_num(radius)
    x = rng.random((b, cin, h, w)).astype(np.float32)
    k = (rng.normal(0, 1, (cout, cin, kn)) / np.sqrt(cin * kn)).astype(
        np.float32)
    return (_round(x), _round(k)) if bf16 else (x, k)


def _ref(x, k, parity, radius, dilation):
    fn = functools.partial(JP.packed_hex_conv_pallas, even_odd_offset=parity,
                           radius=radius, dilation=dilation)
    return np.asarray(fn(x, k))


PACK_CASES = [  # (name, B, Cin, Cout, H, W, radius, dilation, parity, Wo)
    ("Wo=16, 4 rows a block", 3, 16, 32, 12, 18, 2, 1, 0, 16),
    ("Wo=7, odd parity", 5, 32, 64, 11, 9, 2, 1, 1, 7),
    ("Wo=3, 21 rows a block", 3, 16, 24, 10, 5, 2, 1, 0, 3),
    ("dilation 2", 2, 16, 32, 13, 11, 2, 2, 1, 7),
    ("radius 3", 3, 16, 16, 12, 9, 3, 1, 0, 5),
    ("Wo=68, two tiles a row", 1, 16, 64, 6, 70, 2, 1, 1, 68),
]


@pytest.mark.parametrize("case", PACK_CASES, ids=[c[0] for c in PACK_CASES])
def test_packed_f32_tiles_match_packed_hex_conv_pallas(case):
    _, b, cin, cout, h, w, r, d, parity, wo = case
    x, k = _inputs(70 + PACK_CASES.index(case), b, cin, cout, h, w, r)
    want = _ref(x, k, parity, r, d)
    assert want.shape[-1] == wo
    got = packed_tile_conv(x, k, parity, r, d)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL


MMA_CASES = [  # (name, B, Cin, Cout, H, W, radius, dilation, parity)
    ("one chunk, odd parity", 1, 16, 32, 6, 70, 2, 1, 1),
    ("two chunks, Cout 48", 1, 32, 48, 5, 20, 2, 1, 0),
    ("dilation 2", 1, 16, 16, 9, 13, 2, 2, 1),
]


@pytest.mark.parametrize("case", MMA_CASES, ids=[c[0] for c in MMA_CASES])
def test_nchw_mma_tile_matches_packed_hex_conv_pallas(case):
    _, b, cin, cout, h, w, r, d, parity = case
    x, k = _inputs(80 + MMA_CASES.index(case), b, cin, cout, h, w, r, True)
    want = _ref(x, k, parity, r, d)
    got = nchw_mma_conv(x, k, parity, r, d)
    assert got.shape == want.shape
    rel = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert rel <= TOL


# ---- the host helpers -------------------------------------------------------

# (B, Cin, Cout, Ho, Wo) -> the float32 plan at radius 2: BN-CIFAR's and
# BN-512's layers (the valid table's patch is 3 rows x 66 columns)
PLANS = {
    (256, 32, 32, 16, 16): dict(cob=32, S=4, sw=16, ncs=18, nv=72,
                                tiles0=512, tiles=1024),
    (256, 32, 64, 8, 7): dict(cob=64, S=9, sw=7, ncs=9, nv=81,
                              tiles0=114, tiles=228),
    (256, 128, 128, 4, 3): dict(cob=64, S=21, sw=3, ncs=5, nv=105,
                                tiles0=25, tiles=50),
    (32, 32, 32, 256, 256): dict(cob=32, S=1, sw=64, ncs=66, nv=66,
                                 tiles0=16384, tiles=32768),
    (32, 128, 128, 64, 63): dict(cob=64, S=1, sw=64, ncs=66, nv=66,
                                 tiles0=1024, tiles=2048),
    (3, 16, 16, 5, 1): dict(cob=16, S=64, sw=1, ncs=3, nv=192,
                            tiles0=1, tiles=2),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=[
    "b{0} {1}->{2} {3}x{4}".format(*s) for s in PLANS])
def test_f32_plan_of_the_per_module_layers(shape):
    b, cin, cout, ho, wo = shape
    table = conv_single._valid_taps(2, 1, 1)
    assert conv_single._patch(table) == (3, 66)
    plan = conv_single._f32_plan(b, cin, cout, ho, wo, 7, 3, 66)
    assert plan == PLANS[shape]
    assert conv_single._f32_smem(plan["cob"], 3, 7, plan["nv"]) <= \
        conv_single._MAX_SMEM
    assert conv_single._grid(torch.float32, b, cin, cout, ho, wo, 7,
                             table) == (plan["tiles"],
                                        -(-cout // plan["cob"]))


def test_f32_plan_gives_way_where_shared_memory_is_short():
    """Radius 5 (61 taps): 64 output channels' weights (250 KB) do not fit,
    so the tile takes 32; at Wo=1 the 64 packed rows' patches do not fit
    beside 16 channels' weights, so the rows halve."""
    table = conv_single._valid_taps(5, 1, 0)
    rows, cols = conv_single._patch(table)
    plan = conv_single._f32_plan(2, 64, 128, 20, 40, 61, rows, cols)
    assert (plan["cob"], plan["S"]) == (32, 1)
    assert conv_single._f32_smem(64, rows, 61, plan["nv"]) > \
        conv_single._MAX_SMEM
    tiny = conv_single._f32_plan(2, 16, 16, 20, 1, 61, rows, cols)
    assert tiny["cob"] == 16 and tiny["S"] < 64
    assert conv_single._f32_smem(16, rows, 61, tiny["nv"]) <= \
        conv_single._MAX_SMEM < conv_single._f32_smem(16, rows, 61,
                                                      2 * tiny["nv"])


def test_bf16_grid_is_kernel_b_tile():
    """bf16: one output row's 64 pixels a block, kernel B's N."""
    table = conv_single._valid_taps(2, 1, 1)
    for cin, cout, n in [(32, 32, 32), (32, 48, 64), (64, 128, 128),
                         (16, 16, 16)]:
        assert conv_single._grid(torch.bfloat16, 32, cin, cout, 64, 63, 7,
                                 table) == (1, 64, 32 * -(-cout // n))
        assert conv_stack._tile_n(torch.bfloat16, cin, cout, 7,
                                  *conv_stack._patch_shape(2, 1, False)) == n
