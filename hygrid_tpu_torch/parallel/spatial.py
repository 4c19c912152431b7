"""Row-sharded image ops with explicit halo exchange, PyTorch port of
``hygrid_tpu/parallel/spatial.py``.

Each rank holds one slab of the image's rows (and, on a 2-D mesh, of its
columns), in :func:`~.mesh.shard_batch`'s layout: rows zero-padded to a
multiple of twice the row axis, so every slab has an even height and
starts on an even hex row; columns to a multiple of the column axis.
Inputs and outputs are this rank's slab: no rank holds the whole image.
Boundary rows travel to the neighbours by send/recv (``halo_exchange``),
the counterpart of the reference's two ``ppermute`` rounds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _comm
from ..nn import functional as F
from ..utils.profiling import get_logger

__all__ = ["halo_exchange", "sharded_hex_conv2d", "sharded_hex_conv2d_fn",
           "sharded_resample", "shard_plans"]


def _take(a: torch.Tensor, axis: int, start: int, stop: int):
    return a.narrow(axis, start, stop - start)


class _HaloExchange(torch.autograd.Function):
    """``lo`` rows from the previous rank on top, ``hi`` rows from the next
    below, zeros at the global edges.  The backward sends each halo's
    gradient back to the rank its rows came from, which adds it to them
    (the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, lo, hi, group, axis):
        ranks = _comm.group_ranks(group)
        i, n = ranks.index(torch.distributed.get_rank()), len(ranks)
        ctx.geometry = (lo, hi, group, axis, ranks, i, n)
        size = x.shape[axis]
        sends, recvs = [], []
        if lo and i < n - 1:
            sends.append((_take(x, axis, size - lo, size), ranks[i + 1]))
        if hi and i > 0:
            sends.append((_take(x, axis, 0, hi), ranks[i - 1]))

        def shape(rows):
            s = list(x.shape)
            s[axis] = rows
            return tuple(s)

        if lo and i > 0:
            recvs.append((shape(lo), ranks[i - 1]))
        if hi and i < n - 1:
            recvs.append((shape(hi), ranks[i + 1]))
        got = iter(_comm.exchange(group, sends, recvs, x))
        parts = [x]
        if lo:
            parts.insert(0, next(got) if i > 0 else x.new_zeros(shape(lo)))
        if hi:
            parts.append(next(got) if i < n - 1 else x.new_zeros(shape(hi)))
        return torch.cat(parts, axis)

    @staticmethod
    def backward(ctx, g):
        lo, hi, group, axis, ranks, i, n = ctx.geometry
        size = g.shape[axis] - lo - hi
        g_mid = _take(g, axis, lo, lo + size).clone()
        sends, recvs = [], []
        if lo and i > 0:        # my top halo came from the previous rank
            sends.append((_take(g, axis, 0, lo), ranks[i - 1]))
        if hi and i < n - 1:    # my bottom halo came from the next rank
            sends.append((_take(g, axis, lo + size, lo + size + hi),
                          ranks[i + 1]))

        def shape(rows):
            s = list(g.shape)
            s[axis] = rows
            return tuple(s)

        if lo and i < n - 1:
            recvs.append((shape(lo), ranks[i + 1]))
        if hi and i > 0:
            recvs.append((shape(hi), ranks[i - 1]))
        got = iter(_comm.exchange(group, sends, recvs, g))
        if lo and i < n - 1:
            _take(g_mid, axis, size - lo, size).add_(next(got))
        if hi and i > 0:
            _take(g_mid, axis, 0, hi).add_(next(got))
        return g_mid, None, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int, group,
                  axis: int = -2) -> torch.Tensor:
    """Extend this rank's block with ``lo`` rows from the previous rank of
    ``group`` and ``hi`` rows from the next, zero-filled at the global
    edges (``hygrid_tpu/parallel/spatial.py:37-67``).

    ``group`` is the process group along the sharded axis (``mesh.group(
    "sp")``); its rank order is the slabs' order.  One round of sends and
    receives, posted together; differentiable.
    """
    axis = axis % x.ndim
    if lo == 0 and hi == 0:
        return x
    return _HaloExchange.apply(x, int(lo), int(hi), group, axis)


def _slab_crop(out: torch.Tensor, mesh, axis_name, col_axis_name, size):
    """Zero the rows (and columns) of this rank's output slab that lie past
    the global ``size``: the slab layout of the reference's cropped
    output, so that the next sharded op reads zeros there."""
    if size is None:
        return out
    h, w = size
    hs, ws = out.shape[-2:]
    keep_r = min(hs, max(0, h - mesh.coords[axis_name] * hs))
    keep_c = ws
    if col_axis_name:
        keep_c = min(ws, max(0, w - mesh.coords[col_axis_name] * ws))
    if (keep_r, keep_c) == (hs, ws):
        return out
    return torch.nn.functional.pad(out[..., :keep_r, :keep_c],
                                   (0, ws - keep_c, 0, hs - keep_r))


def sharded_hex_conv2d_fn(kernel, bias=None, *, even_odd_offset: int = 0,
                          radius: int, group, impl: str = "auto"):
    """Per-slab body of a row-sharded 'same' hex conv (stride and dilation
    1) along ``group``: ``radius - 1`` halo rows from each neighbour, the
    width padded locally, and the parity handed to the conv shifted by the
    halo rows prepended (``hygrid_tpu/parallel/spatial.py:70-89``)."""
    p = radius - 1

    def body(x):
        x = halo_exchange(x, p, p, group) if p else x
        x = F.pad2d(x, (p, p, 0, 0))  # width-only local padding
        return F.hex_conv2d(
            x, kernel, bias, even_odd_offset=(even_odd_offset + p) % 2,
            radius=radius, stride=1, padding=0, impl=impl)

    return body


def sharded_hex_conv2d(x: torch.Tensor, kernel, mesh, bias=None, *,
                       even_odd_offset: int = 0, radius: int,
                       axis_name: str = "sp",
                       col_axis_name: Optional[str] = None,
                       impl: str = "auto",
                       size: Optional[Tuple[int, int]] = None):
    """Row-sharded (1-D mesh) or row- and column-sharded (2-D mesh) 'same'
    hex convolution of this rank's slab ``x`` (``shard_batch`` layout).

    Equivalent to ``hex_conv2d(x, kernel, padding=radius-1)`` on the whole
    image, in the same slab layout.  ``size=(H, W)`` is the image's size
    when the slabs were padded: the output's rows and columns past it are
    zeroed, as the reference crops them, so chained convs read zeros
    there.  Halos travel on both axes; parity is kept because every slab
    starts on an even row; ``impl`` goes to ``hex_conv2d`` unchanged
    (``"pallas"`` runs ``hex_conv_single``).
    """
    nr = mesh.shape[axis_name]
    if x.shape[-2] % 2 and nr > 1:
        raise ValueError(f"row slab of height {x.shape[-2]} is odd: shard "
                         "with shard_batch (even slabs)")
    p = radius - 1
    v = x
    if p:
        v = halo_exchange(v, p, p, mesh.group(axis_name))
        if col_axis_name:
            v = halo_exchange(v, p, p, mesh.group(col_axis_name), axis=-1)
        else:
            v = F.pad2d(v, (p, p, 0, 0))
    out = F.hex_conv2d(v, kernel, bias,
                       even_odd_offset=(even_odd_offset + p) % 2,
                       radius=radius, stride=1, padding=0, impl=impl)
    return _slab_crop(out, mesh, axis_name, col_axis_name, size)


@dataclasses.dataclass
class ShardPlans:
    """The per-shard sampling plans of one sharded resample: the halo sizes
    (rows ``lo_r``/``hi_r``, columns ``lo_c``/``hi_c``), the slab shapes
    of source and output, the plans and each shard's plan index ``gid``
    (``(rows, cols)``), and the host seconds the build took."""
    plans: List[object]
    gid: np.ndarray
    halos: Tuple[int, int, int, int]
    src_slab: Tuple[int, int]
    out_slab: Tuple[int, int]
    seconds: float


def shard_plans(kind: str, size: Tuple[int, int], dsize: Tuple[int, int],
                interpolation: str, nr: int, nc: int = 1,
                max_groups: int = 32) -> ShardPlans:
    """Build the per-shard :class:`SamplePlan` s of a sharded resample from
    the global plan, on the host in float64 numpy, as
    ``hygrid_tpu/parallel/spatial.py:128-262`` does: static halos covering
    every shard's live reads, shards lifted onto the canonical interior
    pattern where they can be (bit-equal to the monolithic op), else
    grouped by their k-sorted patterns."""
    from ..ops import sampling
    from ..ops.geometry import _linspace_grid
    from .. import lattice

    t0 = time.perf_counter()
    h, w = size
    h1, w1 = dsize
    box_kind = {"rect_to_hex": "rect_source", "hexresize": "hexresize",
                "hex_to_rect": "hex_to_rect"}[kind]
    gx, gy = _linspace_grid(lattice.corner_box(box_kind, h, w), h1, w1)
    if kind == "rect_to_hex":
        plan = sampling.rect_sample_plan(gx, gy, h, w, interpolation)
    else:
        plan = sampling.hex_sample_plan(gx, gy, h, w, interpolation)

    # pad-and-crop: even source slabs (every slab starts on an even hex
    # row), zero-weight-extended output grid
    hp = -(-h // (2 * nr)) * (2 * nr)
    wp = -(-w // nc) * nc
    h1p = -(-h1 // nr) * nr
    w1p = -(-w1 // nc) * nc
    idx, wts = plan.idx, plan.weights
    if (h1p, w1p) != (h1, w1):
        pad = ((0, 0), (0, h1p - h1), (0, w1p - w1))
        idx, wts = np.pad(idx, pad), np.pad(wts, pad)
    rows, cols = idx // w, idx % w
    hs, ws = hp // nr, wp // nc
    h1s, w1s = h1p // nr, w1p // nc
    valid = wts != 0

    # static halo sizes covering every shard's live reads
    lo_r = hi_r = lo_c = hi_c = 0
    for i in range(nr):
        for j in range(nc):
            blk = (slice(None), slice(i * h1s, (i + 1) * h1s),
                   slice(j * w1s, (j + 1) * w1s))
            v = valid[blk]
            if not v.any():
                continue
            ri = rows[blk][v] - i * hs
            ci = cols[blk][v] - j * ws
            lo_r = max(lo_r, int(-ri.min()))
            hi_r = max(hi_r, int(ri.max() - (hs - 1)))
            lo_c = max(lo_c, int(-ci.min()))
            hi_c = max(hi_c, int(ci.max() - (ws - 1)))
    if lo_r >= hs or hi_r >= hs or lo_c >= ws or hi_c >= ws:
        raise ValueError(
            f"resample needs halos rows ({lo_r},{hi_r}) / cols "
            f"({lo_c},{hi_c}) >= slab ({hs},{ws}); use ops.tiled for "
            "extreme scale changes")
    band_r = hs + lo_r + hi_r
    band_c = ws + lo_c + hi_c

    def block(i, j, sort):
        blk = (slice(None), slice(i * h1s, (i + 1) * h1s),
               slice(j * w1s, (j + 1) * w1s))
        lr = rows[blk] - i * hs + lo_r
        lc = cols[blk] - j * ws + lo_c
        bw = wts[blk]
        v = bw != 0
        lr, lc = np.where(v, lr, 0), np.where(v, lc, 0)
        if sort:
            # canonical k-order: plan builders assign interpolation terms
            # to k slots in a per-row order that can differ between shards
            # while the sum is identical; a stable per-pixel sort by read
            # position makes order-equal patterns byte-equal so they share
            # one group (at the cost of a summation reorder, <= ~1 ulp)
            key = np.where(v, lr.astype(np.int64) * band_c + lc,
                           np.iinfo(np.int64).max)
            order = np.argsort(key, axis=0, kind="stable")
            lr = np.take_along_axis(lr, order, 0)
            lc = np.take_along_axis(lc, order, 0)
            bw = np.take_along_axis(bw, order, 0)
            v = bw != 0
        return lr, lc, bw, v

    def build_groups(sort):
        """Group shards by local pattern; group 0 is the canonical interior
        pattern, whose off-image reads land in halo_exchange's zero-filled
        halo rows/cols, contributing 0: the zero-weight semantics of the
        clamped monolithic plan, so edge shards usually lift onto it
        (checked entry-wise)."""
        ci0, cj0 = nr // 2, nc // 2
        clr, clc, cw, _cv = block(ci0, cj0, sort)

        def lifts(lr, lc, bw, v, i, j):
            if not (np.array_equal(np.where(v, lr, 0), np.where(v, clr, 0))
                    and np.array_equal(np.where(v, lc, 0),
                                       np.where(v, clc, 0))
                    and np.abs(np.where(v, bw - cw, 0)).max() <= 2e-6):
                return False
            inv = ~v & (cw != 0)
            if inv.any():
                gr = clr - lo_r + i * hs
                gc = clc - lo_c + j * ws
                off = (gr < 0) | (gr >= h) | (gc < 0) | (gc >= w)
                if not (off | ~inv).all():
                    return False
            return True

        groups = [(clr, clc, cw)]
        keys = {(clr.tobytes(), clc.tobytes(), cw.tobytes()): 0}
        gid = np.zeros((nr, nc), np.int32)
        for i in range(nr):
            for j in range(nc):
                if (i, j) == (ci0, cj0):
                    continue
                lr, lc, bw, v = block(i, j, sort)
                if lifts(lr, lc, bw, v, i, j):
                    continue
                pat = (lr, lc, bw)
                key = tuple(p.tobytes() for p in pat)
                if key not in keys:
                    keys[key] = len(groups)
                    groups.append(pat)
                gid[i, j] = keys[key]
        return groups, gid

    # unsorted first: when every shard lifts onto the canonical pattern in
    # the plan's own k-order, results are bit-identical to the monolithic
    # op; otherwise re-group after canonical k-sorting (<= ~1 ulp reorder)
    groups, gid = build_groups(sort=False)
    if len(groups) > 1:
        groups, gid = build_groups(sort=True)
    if len(groups) > max_groups:
        raise ValueError(
            f"{len(groups)} distinct per-shard sampling patterns exceed "
            f"max_groups={max_groups}; use ops.tiled for this geometry")

    plans = [sampling.SamplePlan((lr * band_c + lc).astype(np.int32), bw,
                                 (band_r, band_c), (h1s, w1s),
                                 plan.exact_select)
             for lr, lc, bw in groups]
    return ShardPlans(plans, gid, (lo_r, hi_r, lo_c, hi_c), (hs, ws),
                      (h1s, w1s), time.perf_counter() - t0)


def sharded_resample(image: torch.Tensor, mesh, kind: str, dsize,
                     interpolation: str = "linear", axis_name: str = "sp",
                     col_axis_name: Optional[str] = None,
                     max_groups: int = 32, *, size: Tuple[int, int]):
    """Resample this rank's slab of an image sharded over a 1-D (rows) or
    2-D (rows x columns) mesh (``hygrid_tpu/parallel/spatial.py:92-286``).

    ``image`` is this rank's ``(..., H/nr, W/nc)`` slab in ``shard_batch``
    layout of the global ``size=(H, W)``; returns this rank's slab of the
    ``dsize=(h1, w1)`` output: ``(..., h1p/nr, w1p/nc)`` with ``h1`` and
    ``w1`` padded to multiples of the axis sizes, the rows and columns
    past ``dsize`` zero (zero-weight plan entries).  The per-shard plans
    are built on the host from the global plan once per call
    (:func:`shard_plans`; its seconds go to the logger), and this rank
    applies its own through ``apply_plan_auto`` (``plan_gather`` or
    ``shift_resample`` on the card).

    kind: ``'rect_to_hex'`` | ``'hexresize'`` | ``'hex_to_rect'``.
    """
    from ..ops import sampling

    nr = mesh.shape[axis_name]
    nc = mesh.shape[col_axis_name] if col_axis_name else 1
    sp = shard_plans(kind, tuple(size), tuple(dsize), interpolation, nr, nc,
                     max_groups)
    get_logger().debug("sharded_resample %s %s -> %s: %d plan(s) in %.3f s",
                       kind, tuple(size), tuple(dsize), len(sp.plans),
                       sp.seconds)
    if tuple(image.shape[-2:]) != sp.src_slab:
        raise ValueError(f"slab {tuple(image.shape[-2:])} is not the "
                         f"shard_batch slab {sp.src_slab} of {tuple(size)} "
                         f"over ({nr}, {nc})")
    lo_r, hi_r, lo_c, hi_c = sp.halos
    x = image
    if lo_r or hi_r:
        x = halo_exchange(x, lo_r, hi_r, mesh.group(axis_name))
    if col_axis_name and (lo_c or hi_c):
        x = halo_exchange(x, lo_c, hi_c, mesh.group(col_axis_name), axis=-1)
    i = mesh.coords[axis_name]
    j = mesh.coords[col_axis_name] if col_axis_name else 0
    return sampling.apply_plan_auto(x.contiguous(), sp.plans[sp.gid[i, j]])
