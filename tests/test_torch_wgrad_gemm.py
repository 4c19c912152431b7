"""The bf16 weight-gradient GEMM that ``csrc/hex_conv_wgrad.cu``'s tensor-core
partial pass computes, written in plain PyTorch here and held against
hygrid_tpu's conv VJP on the CPU.

Per chunk of image rows (``conv_stack._wgrad_chunks``), per output row and
64-pixel step, the x patch the taps reach is staged once and each tap's
operand is a shifted window of it (the descriptor offset the kernel
takes); the tap's product is ``window^T @ g`` over the step's pixels, into
the chunk's float32 partial sums, which are then folded in chunk order.
Reference: ``jax.vjp`` of ``hygrid_tpu.nn.functional.hex_conv2d(impl=
"direct")`` with respect to the kernel.

Tolerances: float32 within 1e-5 relative to max |ref| (summation order
only); bf16 operands (x and the cotangent rounded on both sides, products
in float32) within 1e-5 relative too.  The host helpers (the block's tile,
the chunks and the partial scratch) are checked exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.nn import functional as JF
from hygrid_tpu_torch.kernels import conv_stack as tcs
from hygrid_tpu_torch.nn import functional as TF

REL = 1e-5
STEP = 64     # pixels of one step (hex_conv_wgrad.cu::kStepP)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _round(a):
    """float32 values rounded to bfloat16."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def wgrad_gemm(x, g, taps, dtype, n_chunks=None):
    """dW (Cout, Cin, kn) float32 of NHWC float32 ``x`` (B, H, W, Cin) and
    ``g`` (B, H, W, Cout) for the (2, kn, 2) tap table, as the partial
    pass and the fold compute it, in the chunks ``_wgrad_chunks`` gives
    for ``dtype`` or, given ``n_chunks``, in that many."""
    b, h, w, cin = x.shape
    cout, kn = g.shape[-1], taps.shape[1]
    r_lo, r_hi = int(taps[..., 0].min()), int(taps[..., 0].max())
    c_lo, c_hi = int(taps[..., 1].min()), int(taps[..., 1].max())
    n_rows, n_cols = r_hi - r_lo + 1, STEP + c_hi - c_lo
    per_row = -(-w // STEP)
    rows = b * h
    if n_chunks is None:
        rows_per_chunk, n_chunks = tcs._wgrad_chunks(dtype, rows, cin, cout,
                                                     kn)
    else:
        rows_per_chunk = -(-rows // n_chunks)
        n_chunks = -(-rows // rows_per_chunk)
    # x with zero margins, so that every patch is a plain slice: row o's
    # patch row r is padded row o + r, column j0 + c is padded column j0 + c
    xp = torch.nn.functional.pad(
        torch.from_numpy(x),
        (0, 0, -c_lo, per_row * STEP + c_hi + 1 - w, -r_lo, r_hi))
    gp = torch.nn.functional.pad(torch.from_numpy(g),
                                 (0, 0, 0, per_row * STEP - w))
    partial = torch.zeros((n_chunks, kn, cin, cout))
    for chunk in range(n_chunks):
        for row in range(chunk * rows_per_chunk,
                         min((chunk + 1) * rows_per_chunk, rows)):
            bb, o = divmod(row, h)
            q = o & 1
            for j0 in range(0, per_row * STEP, STEP):
                patch = xp[bb, o:o + n_rows, j0:j0 + n_cols]   # staged once
                gseg = gp[bb, o, j0:j0 + STEP]                  # (64, Cout)
                for t in range(kn):
                    dr, dc = (int(v) for v in taps[q, t])
                    window = patch[dr - r_lo, dc - c_lo:dc - c_lo + STEP]
                    partial[chunk, t] += window.T @ gseg
    dw = partial[0].clone()
    for chunk in range(1, n_chunks):           # the fold, in chunk order
        dw += partial[chunk]
    return dw.permute(2, 1, 0).numpy()


def _dw_ref(x, g, kernel, radius, dilation):
    """jax.vjp of hygrid_tpu's 'same' conv on NHWC x in the kernel."""
    def conv(k):
        y = JF.hex_conv2d(jnp.moveaxis(jnp.asarray(x), -1, 1), k,
                          even_odd_offset=0, radius=radius,
                          padding=dilation * (radius - 1), dilation=dilation,
                          impl="direct")
        return jnp.moveaxis(y, 1, -1)
    _, vjp = jax.vjp(conv, jnp.asarray(kernel))
    (dk,) = vjp(jnp.asarray(g))
    return np.asarray(dk)


CASES = [  # (name, B, H, W, Cin, Cout, radius, dilation, chunks)
    ("stem 3->32, W=127", 2, 5, 127, 3, 32, 2, 1, 3),
    ("Cin 24, W=63", 1, 6, 63, 24, 32, 2, 1, 2),
    ("Cin 40, Cout 24", 1, 5, 63, 40, 24, 2, 1, None),
    ("dilation 2", 3, 4, 21, 16, 32, 2, 2, 2),
    ("radius 3, 19 taps", 1, 9, 17, 8, 48, 3, 1, 2),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wgrad_gemm_matches_the_conv_vjp(case, bf16):
    """Chunks of several rows (samples end inside them) and, with None,
    the chunks of ``_wgrad_chunks`` (a row a chunk at these sizes)."""
    _, b, h, w, cin, cout, r, d, chunks = case
    rng = np.random.default_rng(50 + CASES.index(case))
    kn = TF.hex_kernel_num(r)
    x = rng.random((b, h, w, cin)).astype(np.float32)
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    k = np.zeros((cout, cin, kn), np.float32)
    if bf16:
        x, g = _round(x), _round(g)
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = wgrad_gemm(x, g, tcs._taps(r, d), dtype, chunks)
    want = _dw_ref(x, g, k, r, d)
    assert got.shape == want.shape == (cout, cin, kn)
    assert _rel(got, want) <= REL


def test_split_wgrad_is_the_gemm_on_each_input():
    """12s: the split layer's dW is the GEMM on (A, g) and on (B, g)
    concatenated along Cin; with bf16 operands each half is the unsplit
    layer's dW cut at Ca (24+8, the second input below one chunk)."""
    rng = np.random.default_rng(60)
    b, h, w, ca, cb, cout = 1, 6, 33, 24, 8, 32
    x = _round(rng.random((b, h, w, ca + cb)).astype(np.float32))
    g = _round(rng.normal(size=(b, h, w, cout)).astype(np.float32))
    taps = tcs._taps(2, 1)
    parts = np.concatenate(
        [wgrad_gemm(np.ascontiguousarray(x[..., :ca]), g, taps,
                    torch.bfloat16),
         wgrad_gemm(np.ascontiguousarray(x[..., ca:]), g, taps,
                    torch.bfloat16)], axis=1)
    want = _dw_ref(x, g, np.zeros((cout, ca + cb, 7), np.float32), 2, 1)
    assert _rel(parts, want) <= REL


# ---- the host helpers the bf16 launch uses ----------------------------------

def test_wgrad_tile_follows_cin():
    """bf16: N = 8, 16 or 32 input channels from Cin, 64 output channels,
    7 taps a block; float32: 8, 16 or 32 input and 32 or 64 output channels,
    a warp a tap, 19 taps in three groups of at most 7."""
    bf = torch.bfloat16
    assert [tcs._wgrad_tile(bf, ci, 32, 7) for ci in (1, 3, 8, 9, 16, 17,
                                                     24, 40, 128)] == \
        [(8, 64, 7), (8, 64, 7), (8, 64, 7), (16, 64, 7), (16, 64, 7),
         (32, 64, 7), (32, 64, 7), (32, 64, 7), (32, 64, 7)]
    assert tcs._wgrad_tile(torch.float32, 3, 32, 19) == (8, 32, 7)


# (Cin, Cout, H, W, B) -> (rows_per_chunk, n_chunks) in bf16: HexCNN-small's
# six layers at b=32 and HexUNet-small's split inputs at b=8
CHUNKS = {
    (3, 32, 256, 256, 32): (11, 745),
    (32, 32, 256, 256, 32): (11, 745),
    (32, 64, 128, 127, 32): (6, 683),
    (64, 64, 128, 127, 32): (11, 373),
    (64, 128, 64, 63, 32): (11, 187),
    (128, 128, 64, 63, 32): (21, 98),
    (64, 64, 128, 127, 8): (3, 342),
    (32, 32, 256, 256, 8): (3, 683),
}


@pytest.mark.parametrize("shape", list(CHUNKS), ids=[
    "{0}->{1} {2}x{3} b={4}".format(*s) for s in CHUNKS])
def test_wgrad_chunks_and_scratch(shape):
    """The bf16 chunking: blocks (chunks x channel tiles x tap groups) at
    ``_WGRAD_BLOCKS``, each chunk at least one row, the rows spread
    evenly, and the float32 partial scratch it implies; float32 at the
    same target over its own tile."""
    cin, cout, h, w, b = shape
    rows = b * h
    rpc, n = tcs._wgrad_chunks(torch.bfloat16, rows, cin, cout, 7)
    assert (rpc, n) == CHUNKS[shape]
    assert (n - 1) * rpc < rows <= n * rpc
    ci, co, taps = tcs._wgrad_tile(torch.bfloat16, cin, cout, 7)
    tiles = -(-cin // ci) * -(-cout // co) * -(-7 // taps)
    assert n * tiles < tcs._WGRAD_BLOCKS + tiles
    scratch = n * 7 * cin * cout * 4       # (n_chunks, kn, Cin, Cout) f32
    assert scratch <= 64 * 2 ** 20
    # float32: the same target over its own tile (all 7 taps a block)
    rpc32, n32 = tcs._wgrad_chunks(torch.float32, rows, cin, cout, 7)
    ci, co, taps = tcs._wgrad_tile(torch.float32, cin, cout, 7)
    assert taps == 7
    tiles = -(-cin // ci) * -(-cout // co)
    want = max(1, min(rows, -(-tcs._WGRAD_BLOCKS // tiles)))
    assert rpc32 == -(-rows // want) and n32 == -(-rows // rpc32)


def test_wgrad_chunks_of_a_tiny_input_are_its_rows():
    assert tcs._wgrad_chunks(torch.bfloat16, 5, 3, 32, 7) == (1, 5)
    assert tcs._wgrad_chunks(torch.bfloat16, 1, 40, 24, 37) == (1, 1)
    # more tiles than the target still run one chunk
    assert tcs._wgrad_chunks(torch.bfloat16, 50, 256, 1024, 61) == (50, 1)
