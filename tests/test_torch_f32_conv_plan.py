"""The float32 conv passes' planning, in pure Python.

Kernel B's CUDA-core tile (``conv_stack._f32_tile``, the mirror of
``csrc/hex_common.cuh::conv_tile_plan``) and the float32 dW's
(``_wgrad_tile``, ``_wgrad_chunks`` and ``_wgrad_f32_plan``, whose plan the
C entry of ``csrc/hex_conv_wgrad.cu`` recomputes and refuses where it
differs) at every conv layer of HexCNN-small (b=32, 512^2 input) and
HexUNet-small (b=8), the P-512 stack (C = 16), the 3-channel stem, edge
shapes and wide dilations (taps in groups): the tile each pass takes, its
shared memory under a block's 227 KB, the grid under CUDA's limits, the
dW's partial scratch, and the tiles' thread layouts (every output covered
once, a warp's shared-memory reads in as few wavefronts as their words
allow).
"""
import pytest
import torch

from hygrid_tpu_torch.kernels import conv_stack as cs

F32 = torch.float32
GRID_YZ = 65535
F32_THREADS = 256      # hex_common.cuh::kF32Threads, the float32 tile's

# (name, B, Cin, Cout, H, W): every conv layer of HexCNN-small and
# HexUNet-small (the decoder's split layers by their concatenated Cin), and
# the P-512 stack's 16-channel layer
LAYERS = [
    ("cnn L0 (stem)", 32, 3, 32, 256, 256),
    ("cnn L1", 32, 32, 32, 256, 256),
    ("cnn L2", 32, 32, 64, 128, 127),
    ("cnn L3", 32, 64, 64, 128, 127),
    ("cnn L4", 32, 64, 128, 64, 63),
    ("cnn L5", 32, 128, 128, 64, 63),
    ("unet enc0", 8, 3, 32, 256, 256),
    ("unet enc1", 8, 32, 64, 128, 127),
    ("unet enc2", 8, 64, 128, 64, 63),
    ("unet dec0", 8, 128, 64, 128, 127),
    ("unet dec1", 8, 64, 32, 256, 256),
    ("P-512", 16, 16, 16, 256, 256),
]

# the float32 tile, (cob, rows, stages), of each layer's conv pass and of
# its dx (the adjoint pass: Cin and Cout swapped)
CONV_TILE = {
    "cnn L0 (stem)": ((32, 8, 1), None),
    "cnn L1": ((32, 8, 2), (32, 8, 2)),
    "cnn L2": ((64, 4, 2), (32, 8, 2)),
    "cnn L3": ((64, 4, 2), (64, 4, 2)),
    "cnn L4": ((64, 4, 2), (64, 4, 2)),
    "cnn L5": ((64, 4, 2), (64, 4, 2)),
    "unet enc0": ((32, 8, 1), None),
    "unet enc1": ((64, 4, 2), (32, 8, 2)),
    "unet enc2": ((64, 4, 2), (64, 4, 2)),
    "unet dec0": ((64, 4, 2), (64, 4, 2)),
    "unet dec1": ((32, 8, 2), (64, 4, 2)),
    "P-512": ((16, 8, 1), (16, 8, 1)),
}

# the float32 dW: (CIB, COB, taps) and (rows_per_chunk, n_chunks); a
# split layer's dW runs on each input (Cin = Ca = Cb: the two parts alike)
WGRAD = {
    "cnn L0 (stem)": ((8, 32, 7), (11, 745)),
    "cnn L1": ((32, 32, 7), (11, 745)),
    "cnn L2": ((32, 64, 7), (6, 683)),
    "cnn L3": ((32, 64, 7), (11, 373)),
    "cnn L4": ((32, 64, 7), (11, 187)),
    "cnn L5": ((32, 64, 7), (21, 98)),
    "unet enc0": ((8, 32, 7), (3, 683)),
    "unet enc1": ((32, 64, 7), (2, 512)),
    "unet enc2": ((32, 64, 7), (3, 171)),
    "unet dec0": ((32, 64, 7), (3, 342)),
    "unet dec1": ((32, 32, 7), (3, 683)),
    "P-512": ((16, 32, 7), (6, 683)),
}


def _layer(name):
    return next(layer for layer in LAYERS if layer[0] == name)


def _kn(radius):
    return 3 * radius * radius - 3 * radius + 1


def _f32_grid(b, cout, h, w, cob, rows):
    return (-(-w // cs._TILE_P), -(-h // rows), b * -(-cout // cob))


def _wavefronts(words):
    """Shared-memory wavefronts of one warp-wide load: the most distinct
    32-bit words any one of the 32 banks serves."""
    per_bank = {}
    for word in set(words):
        per_bank.setdefault(word % 32, set()).add(word)
    return max(len(v) for v in per_bank.values())


def _fewest(words):
    return -(-len(set(words)) // 32)


# ---- kernel B's float32 tile ------------------------------------------------

# the stem's input needs no grad: no dx pass
PASSES = [(name, adjoint) for name, tiles in CONV_TILE.items()
          for adjoint in (False, True) if tiles[adjoint] is not None]


@pytest.mark.parametrize("name,adjoint", PASSES, ids=[
    f"{name} {'dx' if adjoint else 'conv'}" for name, adjoint in PASSES])
def test_f32_tile_at_the_model_layers(name, adjoint):
    """The tile each float32 conv pass and dx pass of the two models takes,
    its shared memory (``stages`` copies of one chunk's patch and weights)
    within a block's 227 KB, and its grid within CUDA's limits."""
    _, b, cin, cout, h, w = _layer(name)
    want = CONV_TILE[name][adjoint]
    if adjoint:
        cin, cout = cout, cin
    n_rows, n_cols = cs._patch_shape(2, 1, adjoint)
    assert (n_rows, n_cols) == (3, 66)
    plan = cs._f32_tile(cin, cout, cs._tap_rows(2, 1, adjoint), n_cols)
    cob, rows, stages, smem = (plan[k] for k in ("cob", "rows", "stages",
                                                 "smem"))
    assert (cob, rows, stages) == want
    assert (plan["taps"], plan["band"]) == (7, 3)     # one group
    assert smem == 4 * stages * ((rows + 2) * 66 * 16 + 7 * 16 * cob)
    assert smem <= cs._MMA_MAX_SMEM
    # two blocks an SM, each with the 1 KB the card reserves for it
    assert 2 * (smem + 1024) <= 228 * 1024
    assert cs._tile_n(F32, cin, cout, 7, n_rows, n_cols) == cob
    gx, gy, gz = _f32_grid(b, cout, h, w, cob, rows)
    assert gy <= GRID_YZ and gz <= GRID_YZ
    # 256 threads, 8 pixels x 8 channels each (4 where cob = 16)
    assert rows * cs._TILE_P * cob == F32_THREADS * 8 * min(cob // 4, 8)


@pytest.mark.parametrize("cin,cout,radius,want", [
    (33, 65, 4, (64, 4, 1)),      # two stages of 37 taps' weights do not fit
    (65, 33, 4, (64, 4, 1)),
    (64, 128, 5, (32, 8, 1)),     # 61 taps: one stage of 64 channels either
    (16, 16, 5, (16, 8, 1)),
    (8, 24, 3, (32, 8, 1)),
    (40, 24, 3, (32, 8, 2)),
])
def test_f32_tile_falls_back_where_shared_memory_is_short(cin, cout, radius,
                                                          want):
    """Two stages first, then one, then half the channels: the first that
    fits in 227 KB, and every earlier choice does not."""
    kn = _kn(radius)
    n_rows, n_cols = cs._patch_shape(radius, 1, False)
    plan = cs._f32_tile(cin, cout, cs._tap_rows(radius, 1, False), n_cols)
    cob, rows, stages, smem = (plan[k] for k in ("cob", "rows", "stages",
                                                 "smem"))
    assert (cob, rows, stages) == want
    assert plan["taps"] == kn
    assert smem <= cs._MMA_MAX_SMEM
    first = next(c for c in (16, 32, 64) if cout <= c or c == 64)
    earlier = [(c, s) for c in (64, 32, 16) if c <= first
               for s in ((2, 1) if cin > 16 else (1,))]
    for c, s in earlier[:earlier.index((cob, stages))]:
        assert cs._f32_smem(kn, c, s, n_rows, n_cols) > cs._MMA_MAX_SMEM


def test_f32_tile_raises_where_nothing_fits():
    assert cs._f32_tile(64, 64, ((0, 8),) * 61, 2000) is None
    with pytest.raises(ValueError, match="no float32 tile"):
        cs._tile_n(F32, 64, 64, 61, 9, 2000)


@pytest.mark.parametrize("radius,dilation", [(2, 1), (2, 3), (3, 1),
                                             (3, 8), (5, 2)])
@pytest.mark.parametrize("adjoint", [False, True])
def test_tap_rows_follow_the_table(radius, dilation, adjoint):
    """Each tap's rows over both parities (one row: the hex tables' dr does
    not depend on the parity); one group of all the taps reaches the
    patch's rows, a group of one tap one row."""
    table = (cs._adjoint_taps if adjoint else cs._taps)(radius, dilation)
    rows = cs._tap_rows(radius, dilation, adjoint)
    assert len(rows) == table.shape[1] == _kn(radius)
    for t, (lo, hi) in enumerate(rows):
        assert lo == hi == table[0, t, 0] == table[1, t, 0]
    kn = len(rows)
    assert cs._band_rows(rows, kn) == cs._patch_shape(radius, dilation,
                                                      adjoint)[0]
    assert cs._band_rows(rows, 1) == 1


WIDE_TILES = [  # (Cin, Cout, radius, dilation, adjoint) -> (cob, stages,
    #              taps a group, band rows)
    ((48, 64, 2, 16, False), (64, 1, 5, 17)),
    ((64, 48, 2, 16, True), (64, 1, 5, 17)),
    ((64, 64, 2, 15, False), (64, 1, 6, 31)),
    ((32, 32, 2, 16, False), (32, 1, 5, 17)),    # the fused stack's C = 32
    ((128, 128, 2, 12, False), (64, 1, 7, 25)),  # whole, one stage
    ((20, 40, 2, 30, False), (64, 2, 1, 1)),
    ((40, 20, 2, 30, True), (32, 2, 1, 1)),
    ((40, 48, 3, 8, False), (32, 1, 16, 25)),
]


@pytest.mark.parametrize("shape,want", WIDE_TILES,
                         ids=[str(s) for s, _ in WIDE_TILES])
def test_f32_tile_groups_the_taps_at_a_wide_dilation(shape, want):
    """Where no tile of all the taps fits in 227 KB, the taps go in groups
    of the most that fit (tried before any smaller group, at every width
    and stage count), each group's stage holding its rows and weights."""
    cin, cout, radius, dilation, adjoint = shape
    rows = cs._tap_rows(radius, dilation, adjoint)
    kn = len(rows)
    n_cols = cs._patch_shape(radius, dilation, adjoint)[1]
    plan = cs._f32_tile(cin, cout, rows, n_cols)
    tg = plan["taps"]
    assert (plan["cob"], plan["stages"], tg, plan["band"]) == want
    assert plan["band"] == cs._band_rows(rows, tg)
    assert plan["smem"] == cs._f32_smem(tg, plan["cob"], plan["stages"],
                                        plan["band"], n_cols)
    assert plan["smem"] <= cs._MMA_MAX_SMEM
    for larger in range(tg + 1, kn + 1):
        band = cs._band_rows(rows, larger)
        assert all(cs._f32_smem(larger, c, 1, band, n_cols) >
                   cs._MMA_MAX_SMEM for c in (16, 32, 64))
    # the groups cover the taps once, in table order
    groups = [list(range(t, min(kn, t + tg))) for t in range(0, kn, tg)]
    assert sum(groups, []) == list(range(kn))
    assert cs._tile_n(F32, cin, cout, kn,
                      *cs._patch_shape(radius, dilation, adjoint),
                      rows) == plan["cob"]


@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 64), (64, 128),
                                      (128, 64), (16, 16)])
def test_f32_passes_plan_every_dilation_to_40(radius, cin, cout):
    """Every dilation up to 40 has a float32 conv tile, dx tile and dW
    block within 227 KB; dilation 1 keeps all the taps in one group."""
    for dilation in range(1, 41):
        for adjoint in (False, True):
            rows = cs._tap_rows(radius, dilation, adjoint)
            n_cols = cs._patch_shape(radius, dilation, adjoint)[1]
            a, b = (cout, cin) if adjoint else (cin, cout)
            plan = cs._f32_tile(a, b, rows, n_cols)
            assert plan is not None and plan["smem"] <= cs._MMA_MAX_SMEM
            if dilation == 1:
                assert plan["taps"] == len(rows)
        rows = cs._tap_rows(radius, dilation, False)
        dw = cs._wgrad_f32_plan(cin, cout, rows,
                                cs._patch_shape(radius, dilation, False)[1])
        assert dw is not None and dw["smem"] <= cs._MMA_MAX_SMEM


def _f32_threads(cob):
    """hex_common.cuh::conv_tile's thread layout: thread -> (row, columns,
    channels)."""
    ct = 8 if cob >= 32 else 4
    cl_lanes = cob // ct
    for t in range(F32_THREADS):
        cl, tc, row = t % 8, (t // 8) % cl_lanes, (t // 8) // cl_lanes
        cols = [cl + 8 * i for i in range(8)]
        chans = [h * (cob // 2) + 4 * tc + j for h in range(ct // 4)
                 for j in range(4)]
        yield t, row, cols, chans


@pytest.mark.parametrize("cob", [16, 32, 64])
def test_f32_tile_threads_cover_the_tile_once(cob):
    """Every (row, column, channel) of the tile belongs to one thread, and
    a warp is one output row (one tap table parity)."""
    seen = {}
    warp_rows = {}
    for t, row, cols, chans in _f32_threads(cob):
        warp_rows.setdefault(t // 32, set()).add(row)
        for c in cols:
            for ch in chans:
                assert (row, c, ch) not in seen
                seen[(row, c, ch)] = t
    assert len(seen) == cs._F32_ROWS[cob] * cs._TILE_P * cob
    assert all(len(r) == 1 for r in warp_rows.values())


def _patch_word(p, c, ck):
    """hex_common.cuh::f32_patch_at: patch pixel p (column c), channel
    ck, each pixel's 16 floats as four swizzled 16-byte units."""
    return p * 16 + ((((ck >> 2) ^ (c >> 1)) & 3) << 2) + (ck & 3)


def test_f32_patch_swizzle_keeps_each_pixel_whole():
    for c in range(80):
        words = [_patch_word(c, c, ck) for ck in range(16)]
        assert sorted(words) == list(range(16 * c, 16 * c + 16))
        # a 16-byte unit stays contiguous and aligned (a cp.async target)
        for g in range(4):
            unit = [_patch_word(c, c, 4 * g + j) for j in range(4)]
            assert unit == list(range(unit[0], unit[0] + 4))
            assert unit[0] % 4 == 0


@pytest.mark.parametrize("cob", [16, 32, 64])
@pytest.mark.parametrize("shift", range(4))
def test_f32_tile_reads_are_one_wavefront(cob, shift):
    """For every tap offset (the window's first column, ``shift`` .. ) and
    channel, a warp's 8 x reads of one pixel slot and its weight reads each
    take one wavefront."""
    n_cols, prow = 66, 1
    threads = list(_f32_threads(cob))
    for warp in range(F32_THREADS // 32):
        lanes = threads[32 * warp:32 * warp + 32]
        for ck in range(16):
            for i in range(8):
                words = []
                for _, row, cols, _ in lanes:
                    c = cols[i] + shift
                    words.append(_patch_word((row + prow) * n_cols + c, c,
                                             ck))
                assert _wavefronts(words) == 1
            for h in range((8 if cob >= 32 else 4) // 4):
                words = []
                for _, _, _, chans in lanes:
                    base = ck * cob + chans[4 * h]
                    words += range(base, base + 4)
                assert _wavefronts(words) == 1


# ---- the float32 dW ---------------------------------------------------------

@pytest.mark.parametrize("name", list(WGRAD))
def test_wgrad_f32_chunks_and_scratch(name):
    """The float32 dW's tile and row chunks at the models' layers: all seven
    taps in one block, the blocks (chunks x channel tiles) at
    ``_WGRAD_BLOCKS``, each chunk at least one row, the rows spread evenly,
    from the shapes alone; two stages in shared memory under 227 KB; the
    grid and the partial scratch's bytes."""
    _, b, cin, cout, h, w = _layer(name)
    if name.startswith("unet dec"):
        cin //= 2
    rows = b * h
    tile = cs._wgrad_tile(F32, cin, cout, 7)
    chunks = cs._wgrad_chunks(F32, rows, cin, cout, 7)
    assert (tile, chunks) == WGRAD[name]
    assert cs._wgrad_chunks(F32, rows, cin, cout, 7) == chunks
    ci, co, taps = tile
    rpc, n = chunks
    assert (n - 1) * rpc < rows <= n * rpc
    tiles = -(-cin // ci) * -(-cout // co) * -(-7 // taps)
    assert tiles <= GRID_YZ
    assert n * tiles < cs._WGRAD_BLOCKS + tiles
    plan = cs._wgrad_f32_plan(cin, cout, cs._tap_rows(2, 1, False),
                              cs._patch_shape(2, 1, False)[1])
    assert plan["stages"] == 2 and plan["threads"] == 224
    assert plan["smem"] <= cs._MMA_MAX_SMEM
    assert 2 * (plan["smem"] + 1024) <= 228 * 1024
    scratch = n * 7 * cin * cout * 4       # (n_chunks, kn, Cin, Cout) f32
    assert scratch <= 48 * 2 ** 20


@pytest.mark.parametrize("cin,cout,radius,want", [
    (33, 65, 4, dict(cib=32, cob=64, taps=8, stages=2)),   # 37 taps: 5 groups
    (64, 128, 5, dict(cib=32, cob=64, taps=8, stages=2)),  # 61 taps: 8 groups
    (40, 24, 5, dict(cib=32, cob=32, taps=8, stages=2)),   # 3 rows a block
    (5, 40, 3, dict(cib=8, cob=64, taps=7, stages=2)),     # 19 taps: 3 groups
    (13, 13, 2, dict(cib=16, cob=32, taps=7, stages=2)),
])
def test_wgrad_f32_plan_at_edge_shapes(cin, cout, radius, want):
    kn = _kn(radius)
    plan = cs._wgrad_f32_plan(cin, cout, cs._tap_rows(radius, 1, False),
                              cs._patch_shape(radius, 1, False)[1])
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] <= cs._MMA_MAX_SMEM
    assert plan["lanes"] * plan["ps"] == 32
    groups = -(-kn // plan["taps"])
    assert plan["taps"] <= 8 and groups == -(-kn // 8)


@pytest.mark.parametrize("cin,cout,dilation,want", [
    (35, 24, 10, (32, 32, 5, 1)),   # two stages of 7 taps' 21 rows: 238 KB
    (32, 64, 10, (32, 64, 5, 1)),
    (48, 64, 16, (32, 64, 5, 1)),
    (3, 32, 20, (8, 32, 5, 1)),
    (20, 40, 30, (32, 64, 1, 2)),   # one tap, one row a block
])
def test_wgrad_f32_takes_fewer_taps_at_a_wide_dilation(cin, cout, dilation,
                                                       want):
    """At radius 2 and a wide dilation the 7 taps' patch does not fit in
    one stage: a block takes the most taps whose rows fit and the grid
    more tap groups."""
    rows = cs._tap_rows(2, dilation, False)
    n_cols = cs._patch_shape(2, dilation, False)[1]
    plan = cs._wgrad_f32_plan(cin, cout, rows, n_cols)
    assert (plan["cib"], plan["cob"], plan["taps"], plan["stages"]) == want
    assert plan["threads"] == 32 * plan["taps"]
    assert plan["smem"] <= cs._MMA_MAX_SMEM
    kp, sx, sg = plan["kp"], plan["sx"], plan["sg"]
    for larger in range(plan["taps"] + 1, 8):
        band = cs._band_rows(rows, larger)
        assert 4 * (kp * sg + band * (n_cols - 64 + kp) * sx) > \
            cs._MMA_MAX_SMEM
    # the chunks follow _wgrad_tile's 7 taps, whatever the dilation
    assert cs._wgrad_tile(F32, cin, cout, 7)[2] == 7


def _wgrad_lanes(cib, cob):
    """hex_conv_wgrad.cu's lane layout: lane -> (slice, input channels,
    output channels)."""
    col_lanes, cil_lanes = cob // 8, cib // 8
    for lane in range(32):
        col = lane % col_lanes
        cil = (lane // col_lanes) % cil_lanes
        sl = lane // (col_lanes * cil_lanes)
        cis = [h * (cib // 2) + 4 * cil + j for h in range(2)
               for j in range(4)]
        cos = [h * (cob // 2) + 4 * col + j for h in range(2)
               for j in range(4)]
        yield sl, cis, cos


TILES = [(8, 32), (8, 64), (16, 32), (16, 64), (32, 32), (32, 64)]


@pytest.mark.parametrize("cib,cob", TILES)
def test_wgrad_f32_lanes_cover_the_tile_and_the_pixels(cib, cob):
    """Each slice's lanes hold every (ci, co) of the tile once, 8 x 8 a
    lane; the slices take each of a step's pixels once."""
    plan = cs._wgrad_f32_plan(cib, cob, cs._tap_rows(2, 1, False), 66)
    ps, kp = plan["ps"], plan["kp"]
    assert kp == (128 if cib == 8 else 64)
    held = {}
    for sl, cis, cos in _wgrad_lanes(cib, cob):
        assert len(cis) * len(cos) == 64
        for ci in cis:
            for co in cos:
                held.setdefault(sl, []).append((ci, co))
    assert len(held) == ps
    for pairs in held.values():
        assert sorted(pairs) == [(ci, co) for ci in range(cib)
                                 for co in range(cob)]
    pixels = [k * ps + sl for sl in range(ps) for k in range(kp // ps)]
    assert sorted(pixels) == list(range(kp))


@pytest.mark.parametrize("cib,cob", TILES)
def test_wgrad_f32_reads_take_the_fewest_wavefronts(cib, cob):
    """A warp's float4 reads of x (pixel stride sx) and of g (stride sg)
    for one pixel step take as few wavefronts as their distinct words
    need, for every tap offset."""
    plan = cs._wgrad_f32_plan(cib, cob, cs._tap_rows(2, 1, False), 66)
    ps, sx, sg = plan["ps"], plan["sx"], plan["sg"]
    assert sx >= cib and sg >= cob and sx % 4 == 0 and sg % 4 == 0
    lanes = list(_wgrad_lanes(cib, cob))
    for shift in range(3):
        for k in (0, 1, plan["kp"] // ps - 1):
            for h in range(2):
                xw, gw = [], []
                for sl, cis, cos in lanes:
                    p = k * ps + sl
                    xb = (p + shift) * sx + cis[4 * h]
                    gb = p * sg + cos[4 * h]
                    xw += range(xb, xb + 4)
                    gw += range(gb, gb + 4)
                assert _wavefronts(xw) == _fewest(xw)
                assert _wavefronts(gw) == _fewest(gw)
