"""The implicit GEMM that kernel B's bf16 conv pass computes
(``csrc/hex_common.cuh::conv_tile_mma``), written in plain PyTorch here and
held against hygrid_tpu's conv on the CPU.

Per output-row parity q the taps are gathered into a (pixels, K) matrix, K
walked as (16-channel chunk, tap, channel) as the kernel walks it; the
weights are the (K, Cout) matrix the kernel's packed weights
(``conv_stack._pack_mma_weights``) hold in that order; one float32 product.
References: ``hygrid_tpu.nn.functional.hex_conv2d(impl="direct")``, its
VJP for dx (the adjoint tap table with the transposed weights), and
``conv_pallas._stack_xla`` for a GroupNorm layer.

Tolerances: float32 within 1e-5 relative to max |ref| (summation order
only); bf16 operands (inputs and weights rounded on both sides, products
in float32) within 1e-5 relative too, before any output rounding.  The
host helpers (the tile's N, the weight packing) are checked exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.nn import functional as TF

REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _round(a):
    """float32 values rounded to bfloat16."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _gemm_weights(wt, bf16):
    """(K, Cout) float32 in the kernel's K order from (kn, Cin, Cout): for
    bf16 the kernel's own packed weights, unpacked; for float32 the same
    order built here."""
    kn, cin, cout = wt.shape
    if bf16:
        packed = tcs._pack_mma_weights(torch.from_numpy(wt))
        return packed.permute(0, 1, 2, 4, 3).reshape(-1, cout).float()
    chunks = -(-cin // 16)
    full = torch.zeros((kn, chunks * 16, cout))
    full[:, :cin] = torch.from_numpy(wt)
    return full.view(kn, chunks, 16, cout).permute(1, 0, 2, 3) \
        .reshape(-1, cout)


def implicit_gemm(inputs, wt, taps, bf16=False):
    """The conv pass on the channel concatenation of the NHWC float32
    ``inputs`` (one, or the split layer's two), weights ``wt`` (kn, Cin,
    Cout) and the (2, kn, 2) tap table, as the bf16 tile computes it.
    Returns float32 (B, H, W, Cout)."""
    xs = [torch.from_numpy(_round(a) if bf16 else a) for a in inputs]
    b, h, w, _ = xs[0].shape
    cin = sum(a.shape[-1] for a in xs)
    kn, _, cout = wt.shape
    chunks = -(-cin // 16)
    bmat = _gemm_weights(wt, bf16)
    pr = int(np.abs(taps[..., 0]).max())
    pc = int(np.abs(taps[..., 1]).max())
    padded = [torch.nn.functional.pad(a, (0, 0, pc, pc, pr, pr))
              for a in xs]
    out = torch.zeros((b, h, w, cout))
    cols = torch.arange(w)
    for q in (0, 1):
        rows = torch.arange(q, h, 2)
        per_tap = []
        for t in range(kn):
            dr, dc = (int(v) for v in taps[q, t])
            r_idx = (rows + dr + pr)[:, None]
            c_idx = (cols + dc + pc)[None, :]
            # each input's channels of the window: the split picks its source
            # per channel, the concatenation is one gather per input
            window = torch.cat([a[:, r_idx, c_idx, :] for a in padded], -1)
            per_tap.append(torch.nn.functional.pad(
                window, (0, chunks * 16 - cin)))
        amat = torch.stack(per_tap, -2)               # (B, R, W, kn, C16)
        amat = amat.view(*amat.shape[:3], kn, chunks, 16) \
            .permute(0, 1, 2, 4, 3, 5).reshape(-1, chunks * kn * 16)
        out[:, rows] = (amat @ bmat).view(b, len(rows), w, cout)
    return out


def _conv_ref(x, kernel, bias, radius, dilation):
    """hygrid_tpu's 'same' conv on NHWC x, NHWC float32 out."""
    y = JF.hex_conv2d(jnp.asarray(np.moveaxis(x, -1, 1)), jnp.asarray(kernel),
                      None if bias is None else jnp.asarray(bias),
                      even_odd_offset=0, radius=radius,
                      padding=dilation * (radius - 1), dilation=dilation,
                      impl="direct")
    return np.moveaxis(np.asarray(y), 1, -1)


def _inputs(seed, b, h, w, cin, cout, radius, bf16):
    rng = np.random.default_rng(seed)
    kn = TF.hex_kernel_num(radius)
    x = rng.random((b, h, w, cin)).astype(np.float32)
    k = rng.normal(0, 1 / np.sqrt(cin * kn), (cout, cin, kn)).astype(
        np.float32)
    return (_round(x), _round(k)) if bf16 else (x, k)


CASES = [  # (name, B, H, W, Cin, Cout, radius, dilation)
    ("stem 3->32, W=127", 2, 5, 127, 3, 32, 2, 1),
    ("32->64, W=63", 1, 6, 63, 32, 64, 2, 1),
    ("Cout=16", 2, 7, 20, 16, 16, 2, 1),
    ("Cout=128", 1, 4, 63, 64, 128, 2, 1),
    ("dilation 2", 1, 9, 21, 16, 32, 2, 2),
    ("radius 3", 1, 9, 17, 40, 24, 3, 1),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_implicit_gemm_matches_hex_conv2d(case, bf16):
    _, b, h, w, cin, cout, r, d = case
    x, k = _inputs(CASES.index(case), b, h, w, cin, cout, r, bf16)
    got = implicit_gemm([x], k.transpose(2, 1, 0), tcs._taps(r, d), bf16)
    want = _conv_ref(x, k, None, r, d)
    assert got.shape == want.shape
    assert _rel(got, want) <= REL


SPLITS = [  # (B, H, W, Ca, Cb, Cout): chunks straddling Ca, and not
    (1, 6, 33, 24, 8, 32),     # Cb below one 16-channel chunk
    (2, 5, 19, 40, 24, 64),    # Ca off the chunk, 64 output channels
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SPLITS, ids=["24+8", "40+24"])
def test_split_implicit_gemm_matches_hex_conv2d_on_the_concat(case, bf16):
    b, h, w, ca, cb, cout = case
    x, k = _inputs(10 + SPLITS.index(case), b, h, w, ca + cb, cout, 2, bf16)
    got = implicit_gemm([x[..., :ca].copy(), x[..., ca:].copy()],
                        k.transpose(2, 1, 0), tcs._taps(2, 1), bf16)
    want = _conv_ref(x, k, None, 2, 1)
    assert _rel(got, want) <= REL


DX_CASES = [  # (B, H, W, Cin, Cout, radius, dilation) of the forward conv
    (2, 7, 63, 32, 64, 2, 1),
    (1, 9, 17, 24, 40, 3, 1),
    (1, 9, 21, 16, 16, 2, 2),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DX_CASES, ids=["r2", "r3", "d2"])
def test_adjoint_implicit_gemm_matches_the_conv_vjp(case, bf16):
    """dx: the GEMM on the adjoint tap table with the weights transposed to
    (kn, Cout, Cin), against jax.vjp of hygrid_tpu's conv in x."""
    b, h, w, cin, cout, r, d = case
    x, k = _inputs(20 + DX_CASES.index(case), b, h, w, cin, cout, r, bf16)
    rng = np.random.default_rng(30 + DX_CASES.index(case))
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    if bf16:
        g = _round(g)
    got = implicit_gemm([g], k.transpose(2, 0, 1), tcs._adjoint_taps(r, d),
                        bf16)
    _, vjp = jax.vjp(lambda v: jnp.asarray(_conv_ref_jnp(v, k, r, d)),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    assert got.shape == x.shape
    assert _rel(got, np.asarray(want)) <= REL


def _conv_ref_jnp(x, kernel, radius, dilation):
    y = JF.hex_conv2d(jnp.moveaxis(x, -1, 1), jnp.asarray(kernel),
                      even_odd_offset=0, radius=radius,
                      padding=dilation * (radius - 1), dilation=dilation,
                      impl="direct")
    return jnp.moveaxis(y, 1, -1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gn_layer_on_the_implicit_gemm_matches_stack_xla(bf16):
    """The GEMM's pre-activation + bias, then the layer's GroupNorm(8) and
    ReLU tail (the port's), against one layer of ``_stack_xla``; 1e-4 as
    for every GN comparison (the norm rescales summation order)."""
    b, h, w, cin, cout = 2, 8, 27, 16, 32
    x, k = _inputs(40, b, h, w, cin, cout, 2, bf16)
    rng = np.random.default_rng(41)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    gamma = (1 + 0.2 * rng.random(cout)).astype(np.float32)
    beta = rng.normal(0, 0.2, cout).astype(np.float32)
    pre = implicit_gemm([x], k.transpose(2, 1, 0), tcs._taps(2, 1), bf16) \
        + torch.from_numpy(bias)
    got = tcs._post_plain(pre, ("gn", 8, torch.from_numpy(gamma),
                                torch.from_numpy(beta)), True, torch.float32)
    norms = [("gn", 8, gamma, beta)]
    kinds, arrays = jcp._split_norms(norms, [k])
    statics = (2, 1, "relu", True, False, None, kinds, None, "NHWC", None,
               False)
    want = np.asarray(jcp._stack_xla(x, [k], (bias,), arrays, statics))
    assert _rel(got.numpy(), want) <= 1e-4


# ---- the host helpers the bf16 launch uses ----------------------------------

@pytest.mark.parametrize("cin,cout", [(3, 32), (16, 16), (40, 24), (5, 130)])
def test_pack_mma_weights_holds_the_kernel_k_order(cin, cout):
    """Unit [c, t, g, co] holds input channels 16c + 8g .. + 7 of tap t for
    output channel co, bf16-rounded, zero past Cin."""
    rng = np.random.default_rng(cin * 1000 + cout)
    wt = rng.normal(size=(7, cin, cout)).astype(np.float32)
    packed = tcs._pack_mma_weights(torch.from_numpy(wt))
    chunks = -(-cin // 16)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (chunks, 7, 2, cout, 8)
    full = np.zeros((7, chunks * 16, cout), np.float32)
    full[:, :cin] = _round(wt)
    for c in range(chunks):
        for g in range(2):
            want = full[:, 16 * c + 8 * g:16 * c + 8 * g + 8, :]   # (7, 8, Co)
            got = packed[c, :, g].float().numpy().transpose(0, 2, 1)
            np.testing.assert_array_equal(got, want)


def test_tile_n_follows_cout_and_shared_memory():
    """N covers Cout with the least of 16/32/64/128, halves while the two
    stages do not fit in 227 KB, and float32 keeps its 32."""
    n = tcs._tile_n
    geo = tcs._patch_shape(2, 1, False)
    assert geo == (3, 66)
    bf = torch.bfloat16
    # HexCNN-small's six layers and the 16-channel pipeline stack
    assert [n(bf, ci, co, 7, *geo) for ci, co in
            [(3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
             (16, 16)]] == [32, 32, 64, 64, 128, 128, 16]
    assert [n(bf, 16, co, 7, *geo) for co in (1, 17, 24, 48, 65, 256)] == \
        [16, 32, 32, 64, 128, 128]
    assert n(torch.float32, 64, 128, 61, 9, 72) == 32
    # radius 4: two stages of N=128 weights (151.5 KB each) do not fit
    r4 = tcs._patch_shape(4, 1, False)
    assert r4 == (7, 70)
    assert n(bf, 33, 65, 37, *r4) == 64
    assert n(bf, 16, 65, 37, *r4) == 128       # one chunk: one stage
    assert n(bf, 64, 128, 61, *tcs._patch_shape(5, 1, False)) == 32
    for ci, co, kn, key in [(33, 65, 37, (4, 1, False)),
                            (64, 128, 61, (5, 1, False)),
                            (128, 128, 7, (2, 1, False))]:
        rows, cols = tcs._patch_shape(*key)
        tile = n(bf, ci, co, kn, rows, cols)
        assert tcs._mma_smem(ci, kn, tile, rows, cols) <= tcs._MMA_MAX_SMEM
        if tile < 128:
            assert tcs._mma_smem(ci, kn, 2 * tile, rows, cols) > \
                tcs._MMA_MAX_SMEM


def test_patch_shape_of_the_adjoint_table():
    for r, d in [(2, 1), (3, 1), (2, 2)]:
        for adjoint in (False, True):
            table = (tcs._adjoint_taps if adjoint else tcs._taps)(r, d)
            rows, cols = tcs._patch_shape(r, d, adjoint)
            assert rows == table[..., 0].max() - table[..., 0].min() + 1
            assert cols == 64 + table[..., 1].max() - table[..., 1].min()
