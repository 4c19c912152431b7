"""The GN/ReLU backward's walk (``csrc/gn_backward.cu``), on the CPU.

``conv_stack.gn_backward_plan`` chooses how the kernel's one cooperative
launch walks a call: chunks of a sample's pixels, one a block, in waves of
whole samples, staged in shared memory (two buffers where they fit).  The
kernel assigns block ``i`` of wave ``w`` the chunk ``i % chunks`` of sample
``w spw + i // chunks``; :func:`_walk` repeats that here, and every plan is
held to the invariants the kernel relies on:

* each (sample, pixel) is in exactly one item;
* a block's staged bytes, all its stages, and its whole shared memory stay
  under the limit it was given;
* no wave has more items than the grid, and the grid no more blocks than
  SMs (one block an SM, all resident);
* every sample's chunks lie in one wave (a block spins on its sample's
  fold).

At HexCNN-small's and HexUNet-small's GN layers on an H100 (132 SMs, 227 KB
a block) bf16 gout is double-buffered and nothing is read twice.  The
schedule's arithmetic in plain PyTorch (chunk partials folded in chunk
order, gpre from the per-group coefficients, its sums by block) is held to
``jax.vjp`` of the reference's GroupNorm + ReLU within 1e-5 relative
(float32, other summation orders), on inputs drawn from a seed with numpy.
"""
from collections import Counter, defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygrid_tpu.kernels import conv_pallas as jcp
from hygrid_tpu_torch.kernels import conv_stack as cs

H100 = (132, 232448)       # SMs, dynamic shared bytes a block may opt in to
# (B, C, H, W) of every GN layer: HexCNN-small's six at b=32, HexUNet-small's
# five at b=8 (enc0-2, the decoder's split layers dec0-1)
MODEL_LAYERS = {
    "hexcnn-L0": (32, 32, 256, 256), "hexcnn-L1": (32, 32, 256, 256),
    "hexcnn-L2": (32, 64, 128, 127), "hexcnn-L3": (32, 64, 128, 127),
    "hexcnn-L4": (32, 128, 64, 63), "hexcnn-L5": (32, 128, 64, 63),
    "hexunet-enc0": (8, 32, 256, 256), "hexunet-enc1": (8, 64, 128, 127),
    "hexunet-enc2": (8, 128, 64, 63), "hexunet-dec0": (8, 64, 128, 127),
    "hexunet-dec1": (8, 32, 256, 256),
}
# (B, HW, C, aligned, SMs, shared bytes): HW off the chunk, HW under one
# chunk, b=1, C from 8 to 1024 (V = 8, 4 and 1; C = 24 and 20 leave warps
# holding parts of pixel rows), unaligned tensors (V = 1), a small card whose
# blocks cannot hold a sample (chunks staged in part), and one that forces
# a single stage
EDGE_CASES = [
    (3, 1000, 64, True) + H100,
    (2, 5, 32, True) + H100,
    (1, 16256, 64, True) + H100,
    (4, 4032, 8, True) + H100,
    (5, 777, 24, True) + H100,
    (3, 301, 20, True) + H100,
    (2, 129, 13, True) + H100,
    (2, 4032, 1024, True) + H100,
    (2, 600, 1024, False) + H100,
    (200, 9, 16, True) + H100,
    (2, 65536, 32, True, 16, 49152),
    (3, 4000, 64, True, 8, 65536),
    (7, 50, 8, False, 3, 10000),
]


def _walk(plan, b, hw):
    """``(wave, block, sample, chunk, p0, npx, staged)`` of every item, as
    the kernel assigns them."""
    for w in range(plan.waves):
        for i in range(plan.grid):
            s = w * plan.spw + i // plan.chunks
            if s >= b:
                continue
            j = i % plan.chunks
            p0 = j * plan.chunk_px
            npx = min(plan.chunk_px, hw - p0)
            yield w, i, s, j, p0, npx, min(npx, plan.staged_px)


def _check(plan, b, hw, c, gout_bytes, sms, limit, aligned=True):
    v, threads, rows = cs.gn_backward_layout(c, aligned)
    assert (plan.v, plan.threads) == (v, threads)
    assert 1 <= threads <= 1024 and threads % (c // v) == 0
    assert plan.grid == plan.spw * plan.chunks <= sms
    assert plan.waves == -(-b // plan.spw) and plan.spw <= b
    assert plan.stages in (1, 2)
    assert 1 <= plan.staged_px <= plan.chunk_px
    assert plan.chunks == -(-hw // plan.chunk_px)
    stage = (cs._pad16(plan.staged_px * c * 4)
             + cs._pad16(plan.staged_px * c * gout_bytes))
    assert plan.stages * stage < plan.smem <= limit
    assert plan.smem == cs.gn_backward_smem(c, gout_bytes, threads, rows,
                                            plan.staged_px, plan.stages)
    covered = np.zeros((b, hw), np.int32)
    waves_of = defaultdict(set)
    items = Counter()
    blocks = Counter()
    for w, i, s, _, p0, npx, _ in _walk(plan, b, hw):
        assert npx >= 1
        covered[s, p0:p0 + npx] += 1
        waves_of[s].add(w)
        items[w] += 1
        blocks[w, i] += 1
    assert (covered == 1).all()
    assert len(waves_of) == b and all(len(ws) == 1 for ws in
                                      waves_of.values())
    assert max(items.values()) <= plan.grid
    assert max(blocks.values()) == 1


@pytest.mark.parametrize("gout_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("layer", list(MODEL_LAYERS))
def test_plan_at_the_models_gn_layers(layer, gout_bytes):
    """On an H100 every GN layer of both models is staged whole (no pixel
    read twice); bf16 gout, the training path's, is double-buffered."""
    b, c, h, w = MODEL_LAYERS[layer]
    plan = cs.gn_backward_plan(b, h * w, c, gout_bytes, *H100)
    _check(plan, b, h * w, c, gout_bytes, *H100)
    assert plan.staged_px == plan.chunk_px
    if gout_bytes == 2:
        assert plan.stages == 2
    # a wave fills most of the card
    assert plan.grid >= 0.9 * H100[0] or plan.chunks == h * w


@pytest.mark.parametrize("gout_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=[f"b{b}-hw{hw}-c{c}-{'a' if al else 'u'}-"
                              f"sm{sm}-{lim}"
                              for b, hw, c, al, sm, lim in EDGE_CASES])
def test_plan_invariants_at_edge_shapes(case, gout_bytes):
    b, hw, c, aligned, sms, limit = case
    plan = cs.gn_backward_plan(b, hw, c, gout_bytes, sms, limit, aligned)
    _check(plan, b, hw, c, gout_bytes, sms, limit, aligned)


def test_plan_stages_in_part_and_single_buffers_where_it_must():
    """A sample larger than every block's shared memory runs one a wave,
    single-buffered, each chunk staging what fits; f32 gout at the 256^2
    layers fits the card once but not twice, so it is single-buffered."""
    part = cs.gn_backward_plan(2, 65536, 32, 4, 16, 49152)
    assert (part.spw, part.stages, part.grid) == (1, 1, 16)
    assert part.staged_px < part.chunk_px
    f32 = cs.gn_backward_plan(32, 65536, 32, 4, *H100)
    assert (f32.stages, f32.spw) == (1, 1)
    bf16 = cs.gn_backward_plan(32, 4032, 128, 2, *H100)
    assert (bf16.stages, bf16.spw, bf16.waves) == (2, 4, 8)


def test_plan_refuses_a_block_that_cannot_stage_a_pixel():
    with pytest.raises(ValueError, match="cannot stage one pixel"):
        cs.gn_backward_plan(2, 64, 1024, 4, 132, 4096)


@pytest.mark.parametrize("c,aligned,want", [
    (32, True, (4, 512, 16)), (128, True, (4, 512, 16)),
    (1024, True, (4, 512, 2)), (24, True, (4, 510, 85)),
    (20, True, (4, 510, 102)), (13, True, (1, 507, 39)),
    (1024, False, (1, 1024, 1)), (16, False, (1, 512, 16)),
])
def test_layout(c, aligned, want):
    """V, threads and the rows left for the tree: 4-channel vectors where
    they are whole and aligned; 512 threads (C where V is 1 and C > 512); a
    warp's lanes reduce by shuffles where they hold whole pixel rows (C / V
    a power of two under 32)."""
    assert cs.gn_backward_layout(c, aligned) == want


def test_scratch_words():
    plan = cs.gn_backward_plan(8, 16256, 64, 2, *H100)
    assert cs.gn_backward_scratch(plan, 8, 64) == (
        2 * 8 * plan.chunks * 64 + 2 * 8 * 64 + plan.grid * 64 + 8 + 1)


def test_stat_views_read_the_forward_stats_in_place():
    """The forward's (B, G, 2) statistics are read as strided views (no
    stack, no copy); other layouts are made contiguous."""
    stats = torch.rand(3, 4, 2)
    mean, rstd, stride = cs._stat_views(stats[..., 0], stats[..., 1], 3, 4)
    assert stride == 2 and mean.data_ptr() == stats.data_ptr()
    assert rstd.data_ptr() == stats.data_ptr() + 4
    m2, r2, s2 = cs._stat_views(stats[..., 0].double(), stats[..., 1], 3, 4)
    assert s2 == 1 and m2.dtype == torch.float32 and m2.is_contiguous()
    assert torch.equal(m2, stats[..., 0]) and torch.equal(r2, stats[..., 1])


def _walk_backward(y, gamma, beta, gout, groups, relu, plan):
    """The kernel's schedule in plain PyTorch, float32: each item's (sum dz
    yhat, sum dz), the sample's folded in chunk order, the per-group
    coefficients, gpre; each block's gpre sums over its items in wave
    order, then the samples' and the blocks' sums in order."""
    b, h, w, c = y.shape
    hw, cpg = h * w, c // groups
    mean, rstd = cs.gn_stats_plain(y, groups)
    yf, gf = y.reshape(b, hw, c), gout.reshape(b, hw, c)
    m = mean.repeat_interleave(cpg, 1)
    r = rstd.repeat_interleave(cpg, 1)
    scale = r * gamma
    shift = beta - m * scale
    f = (rstd < 1e-5 ** -0.5).float()
    gpre = torch.full_like(yf, float("nan"))
    sums = torch.zeros(b, 2, c)
    bpart = torch.zeros(plan.grid, c)
    items = list(_walk(plan, b, hw))
    g = gamma.reshape(groups, cpg)

    def dz_yhat(s, p0, npx):
        ys = yf[s, p0:p0 + npx]
        d = gf[s, p0:p0 + npx]
        if relu:
            d = torch.where(ys * scale[s] + shift[s] > 0, d,
                            torch.zeros_like(d))
        return d, (ys - m[s]) * r[s]

    for wave in range(plan.waves):
        now = [it for it in items if it[0] == wave]
        part = {}
        for _, i, s, j, p0, npx, _ in now:
            d, yh = dz_yhat(s, p0, npx)
            part[s, j] = torch.stack([(d * yh).sum(0), d.sum(0)])
        for s in {it[2] for it in now}:
            for j in range(plan.chunks):
                sums[s] += part[s, j]
        a1 = rstd * (g * sums[:, 1].reshape(b, groups, cpg)).sum(-1) \
            / (hw * cpg)
        a2 = f * rstd * (g * sums[:, 0].reshape(b, groups, cpg)).sum(-1) \
            / (hw * cpg)
        a1, a2 = a1.repeat_interleave(cpg, 1), a2.repeat_interleave(cpg, 1)
        for _, i, s, j, p0, npx, _ in now:
            d, yh = dz_yhat(s, p0, npx)
            gp = scale[s] * d - (a1[s] + a2[s] * yh)
            gpre[s, p0:p0 + npx] = gp
            bpart[i] += gp.sum(0)
    grads = torch.zeros(3, c)
    for s in range(b):
        grads[:2] += sums[s]
    for i in range(plan.grid):
        grads[2] += bpart[i]
    return gpre.reshape(y.shape), grads[0], grads[1], grads[2]


@pytest.mark.parametrize("groups", [1, 4, 16], ids=["G1", "G4", "G=C"])
@pytest.mark.parametrize("card", [H100, (4, 10240)], ids=["h100", "small"])
def test_schedule_matches_jax_vjp(groups, card):
    """The schedule's arithmetic against jax.vjp of the reference's
    GroupNorm (conv_pallas._group_norm_nchw) and ReLU; on the small card
    the walk has several waves and chunks staged in part."""
    b, h, w, c = 5, 9, 13, 16
    rng = np.random.default_rng(groups)
    y = rng.normal(0.2, 1.5, (b, h, w, c)).astype(np.float32)
    gamma = (1 + 0.2 * rng.normal(size=c)).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    gout = rng.normal(size=(b, h, w, c)).astype(np.float32)
    plan = cs.gn_backward_plan(b, h * w, c, 4, *card)
    if card != H100:
        assert plan.waves > 1 and plan.chunks > 1
        assert plan.staged_px < plan.chunk_px
    got = _walk_backward(*(torch.from_numpy(v) for v in (y, gamma, beta,
                                                         gout)),
                         groups, True, plan)

    def tail(y, gamma, beta):
        out = jcp._group_norm_nchw(jnp.moveaxis(y, -1, 1), groups, gamma,
                                   beta)
        return jax.nn.relu(out)

    _, pull = jax.vjp(tail, y, gamma, beta)
    dy, dgamma, dbeta = pull(jnp.moveaxis(jnp.asarray(gout), -1, 1))
    dy = np.asarray(dy, np.float64)
    want = (dy, dgamma, dbeta, dy.sum((0, 1, 2)))
    # at G = C dbias is 0 but for rounding (a one-channel group cancels its
    # bias): held to the sum of |gpre| it adds up
    scales = [np.abs(np.asarray(v, np.float64)).max() for v in want[:3]]
    scales.append(np.abs(dy).sum((0, 1, 2)).max() if groups == c
                  else np.abs(want[3]).max())
    for a, v, scale in zip(got, want, scales):
        err = np.abs(a.numpy().astype(np.float64) - np.asarray(v)).max()
        assert err <= 1e-5 * scale
