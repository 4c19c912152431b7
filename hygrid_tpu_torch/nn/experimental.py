"""Archived / experimental hex ops, PyTorch port of
``hygrid_tpu/nn/experimental.py`` (the reference's ``codes in old
versions.txt``): learned hex<->rect resampling convs, the hex transposed
conv, hex pixel shuffle, quadtree/diamond pooling, an im2col reference conv
and unfold helpers, with ``hygrid_tpu``'s fixes of the archive's bugs.

None of these reaches a TPU kernel in the reference: they are XLA convs,
einsums and strided copies there, and ``torch.nn.functional.conv2d``
(cuDNN on the card), ``torch.einsum`` and tensor indexing here.

All functions take (B, C, H, W) unless they say otherwise.  A tensor stays
on its device; other input follows the kernel when that is a tensor, else
goes to ``device`` (the card unless the caller asks for the CPU).  The
weight initialisers build on ``device`` too.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tF

from .functional import (_as_4d, _conv, _hex_kernel_rows, _input_device,
                         _merge_phases, _reduction, pad2d)
from ..ops.convert import heximage_to_type1, type1_to_heximage
from ..utils.profiling import annotate, span

__all__ = [
    "hex_to_square_downsample_weight",
    "square_downsample_weight",
    "diamond_weight",
    "hex_to_square_conv2d_by_double_stride",
    "square_to_hex_conv2d_by_double_stride",
    "hex_conv_transpose2d",
    "hex_pixel_shuffle",
    "quadtree_hex_pooling",
    "diamond_hex_pooling",
    "hex_to_square_original_resolution",
    "im2col_hex_conv2d",
    "hex_im2col",
    "pixel_even_row_quadtree_unfold",
    "pixel_even_row_dimond_unfold_1",
    "pixel_even_row_square_unfold",
]


def _tensor(x, like=None, device="cuda") -> torch.Tensor:
    """``x`` as a 4-D tensor: a tensor stays on its device, other input
    goes to the device of ``like`` when that is a tensor, else to
    ``device``."""
    return _as_4d(x, _input_device(x, like) if isinstance(like, torch.Tensor)
                  else device)


def _weights(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


# ----------------------- bilinear-style init weights -----------------------

def _broadcast(w: np.ndarray, shape, device) -> torch.Tensor:
    return torch.as_tensor(np.broadcast_to(w, shape).copy(),
                           dtype=torch.float32, device=device)


def hex_to_square_downsample_weight(channels: int, f: int,
                                    device="cuda") -> torch.Tensor:
    """Inverse-distance weights on the hex lattice for a learned hex->rect
    downsample (archive ``generate_weight``, codes:35-48). (C, f, f)."""
    x = np.arange(f, dtype=np.float64)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    dist = 1.0 / np.sqrt((xx - (f - 1) / 2) ** 2 +
                         (0.5 * xx + yy - 3 * (f - 1) / 4) ** 2)
    return _broadcast(dist / dist.sum(), (channels, f, f), device)


def square_downsample_weight(channels: int, f: int,
                             device="cuda") -> torch.Tensor:
    """Rect-lattice analogue (codes:445-457). (C, f*f)."""
    x = np.arange(f, dtype=np.float64)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    dist = 1.0 / np.sqrt((xx - (f - 1) / 2) ** 2 + (yy - (f - 1) / 2) ** 2)
    return _broadcast((dist / dist.sum()).reshape(-1), (channels, f * f),
                      device)


def diamond_weight(channels: int, f: int = 2, device="cuda") -> torch.Tensor:
    """2x2 diamond-cell weights (codes:614-621). (C, f*f)."""
    x = np.arange(f, dtype=np.float64)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    dist = 1.0 / np.sqrt((xx + yy - (f - 1)) ** 2 +
                         (0.5 * xx - 0.5 * yy) ** 2)
    return _broadcast((dist / dist.sum()).reshape(-1), (channels, f * f),
                      device)


# ------------------------- cross-lattice resampling ------------------------

def hex_to_square_conv2d_by_double_stride(x, kernel, *,
                                          even_odd_offset: int = 0,
                                          padding: int = 0,
                                          padding_mode: str = "constant",
                                          padding_value=0, device="cuda"):
    """Learned hex->rect downsample (archive codes:1-66).

    ``kernel``: (C, f, f) per-channel weights (depthwise); the downsample
    factor f must be even.  Scatters row i's taps at type-1 columns
    ``i + 2k`` and runs one even-phase depthwise conv with stride
    (f, 2f - 1).
    """
    x = _tensor(x, kernel, device)
    kernel = _weights(kernel, x)
    c, f, _ = kernel.shape
    if f % 2:
        raise ValueError("downsample factor must be even")
    k_h, k_w = f, 3 * f - 2
    weight = kernel.new_zeros((c, 1, k_h, k_w))
    for i in range(k_h):
        weight[:, 0, i, i:i + (k_h - 1) * 2 + 1:2] += kernel[:, i, :]
    x = pad2d(x, padding, padding_mode, padding_value)
    parity = (even_odd_offset + padding) % 2
    t1 = heximage_to_type1(x, parity)
    sl = t1[:, :, :, 1:None if parity % 2 == 0 else -1]
    return _conv(sl.to(weight.dtype), weight, (f, 2 * f - 1), c)


def square_to_hex_conv2d_by_double_stride(x, kernel, *, padding: int = 0,
                                          padding_mode: str = "constant",
                                          padding_value=0, device="cuda"):
    """Learned rect->hex downsample (archive codes:421-493).

    ``kernel``: (C, f*f); even output rows pool aligned fxf windows, odd
    rows the half-cell-shifted ones, interleaved: a learned version of
    ``rect_to_hex_resample``'s half-resolution default.
    """
    x = _tensor(x, kernel, device)
    kernel = _weights(kernel, x)
    c, ksq = kernel.shape
    f = int(round(math.sqrt(ksq)))
    x = pad2d(x, padding, padding_mode, padding_value)
    even = pixel_even_row_square_unfold(x[:, :, :, :-(f // 2)], f)
    odd = pixel_even_row_square_unfold(x[:, :, f:, (f // 2):], f)
    evenconv = torch.einsum("bchwk,ck->bchw", even.to(kernel.dtype), kernel)
    oddconv = torch.einsum("bchwk,ck->bchw", odd.to(kernel.dtype), kernel)
    return _merge_phases(evenconv, oddconv, None)


# --------------------------- transposed conv -------------------------------

@annotate("hygrid.conv_transpose")
def hex_conv_transpose2d(x, kernel, bias=None, *, even_odd_offset: int = 0,
                         radius: int, stride: int = 1, groups: int = 1,
                         impl: str = "auto", data_format: str = "NCHW",
                         device="cuda"):
    """Hex transposed convolution (archive codes:129-274).

    Semantics: zero-stuff the input onto an upsampled type-1 canvas
    (``input_interpolation``, codes:186-205), pad by ``radius - 1``, then
    run the standard dual-phase conv with stride (2, 2).
    ``kernel``: (O, C // groups, kernelnum).

    ``impl="canvas"`` executes that literally.  ``impl="phase"`` (and
    ``"auto"``, as in ``hygrid_tpu``) runs the phase decomposition of
    :func:`_transpose_phase_plan`: per output-phase class, one strided
    ``conv2d`` of the un-stuffed input with the sub-kernel of the taps that
    ever hit data (eight sub-convs at stride 2), no canvas and no zero
    MACs.  ``impl="matmul"`` evaluates the same plan as one tap matmul
    (float32 accumulation, so a bfloat16 input gives a float32 result, as
    in the reference) and strided reads of it.

    ``data_format="NHWC"`` takes and returns channels-last.
    """
    if impl not in ("auto", "matmul", "phase", "canvas"):
        raise ValueError(f"unknown impl {impl!r}")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r}")
    nhwc = data_format == "NHWC"
    x = _tensor(x, kernel, device)
    kernel = _weights(kernel, x)
    if bias is not None:
        bias = _weights(bias, x)
    if impl != "canvas":
        h, w = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
        s, r = stride, radius
        p = r - 1
        h1p = s * h - s + 1 + 2 * p
        w1p = 2 * s * w - s + 2 + (1 - s % 2) + 4 * p
        he = (h1p - (2 * r - 1)) // 2 + 1
        ho = (h1p - s - (2 * r - 1)) // 2 + 1
        wo = (w1p - 1 - s - (4 * r - 3)) // 2 + 1
        if he > 0 and ho > 0 and wo > 0:
            if impl == "matmul":
                xl = x if nhwc else x.permute(0, 2, 3, 1)
                out = _hex_conv_transpose2d_matmul(
                    xl, kernel, bias, even_odd_offset=even_odd_offset,
                    radius=radius, stride=stride, groups=groups)
                return out if nhwc else out.permute(0, 3, 1, 2)
            out = _hex_conv_transpose2d_phase(
                x.permute(0, 3, 1, 2) if nhwc else x, kernel, bias,
                even_odd_offset=even_odd_offset, radius=radius,
                stride=stride, groups=groups)
            return out.permute(0, 2, 3, 1) if nhwc else out
        if impl in ("phase", "matmul"):
            raise ValueError(f"input too small for the {impl} path; use "
                             "impl='canvas'")
    out = _hex_conv_transpose2d_canvas(
        x.permute(0, 3, 1, 2) if nhwc else x, kernel, bias,
        even_odd_offset=even_odd_offset, radius=radius, stride=stride,
        groups=groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


def _hex_conv_transpose2d_canvas(x, kernel, bias=None, *,
                                 even_odd_offset: int = 0, radius: int,
                                 stride: int = 1, groups: int = 1):
    """The literal canvas formulation (archive codes:129-274)."""
    x = _tensor(x, kernel)
    kernel = _weights(kernel, x)
    b, c, h, w = x.shape
    s, r = stride, radius
    ks = 2 * r - 1
    k_h, k_w = ks, 4 * r - 3

    # input_interpolation: each pixel lands on two adjacent columns of the
    # s-dilated type-1 canvas, with explicit slot counts (the archive's
    # open-ended slices only line up for offset=1, codes:194-202)
    w1 = 2 * s * w - s + 2 + (1 - s % 2)
    h1 = s * h - s + 1
    canvas = x.new_zeros((b, c, h1, w1))
    off = even_odd_offset
    ev = x[:, :, 0::2, :]
    od = x[:, :, 1::2, :]
    for delta in (0, 1):
        col0 = off * s + delta
        canvas[:, :, 0:2 * s * (ev.shape[2] - 1) + 1:2 * s,
               col0:col0 + 2 * s * (w - 1) + 1:2 * s] = ev
        col1 = (1 - off) * s + delta
        if od.shape[2] > 0:
            canvas[:, :, s:s + 2 * s * (od.shape[2] - 1) + 1:2 * s,
                   col1:col1 + 2 * s * (w - 1) + 1:2 * s] = od
    p = r - 1
    canvas = pad2d(canvas, (2 * p, 2 * p, p, p))

    weight = kernel.new_zeros((kernel.shape[0], c // groups, k_h, k_w))
    for (i, t, ln, start) in _hex_kernel_rows(r):
        weight[:, :, i, t:t + (ln - 1) * 2 + 1:2] += \
            kernel[:, :, start:start + ln]

    evenconv = _conv(canvas[:, :, :, 1:-s].to(weight.dtype), weight, (2, 2),
                     groups)
    oddconv = _conv(canvas[:, :, s:, s + 1:].to(weight.dtype), weight,
                    (2, 2), groups)
    return _merge_phases(evenconv, oddconv, bias)


@functools.lru_cache(maxsize=None)
def _transpose_phase_plan(radius: int, stride: int, offset: int):
    """Numerically derive the zero-stuffing-free phase decomposition of
    :func:`hex_conv_transpose2d` (a copy of ``hygrid_tpu``'s, pure numpy).

    The canvas conv is linear with a periodic sparsity pattern: canvas
    occupancy repeats every ``2*stride`` rows/columns, and each conv
    phase advances 2 canvas cells per output step, so output positions
    fall into ``stride x stride`` classes per conv phase.  Within a
    class, the set of kernel taps that hit data, and the input pixel
    each tap reads relative to an affine-in-(y, z) anchor, is
    translation invariant.  This function simulates the canvas path's
    exact index arithmetic on an integer "owner" array and extracts, per
    class, the anchor affine maps and the sub-kernel tap placements.

    Returns ``plans[conv_phase][(ya, za)] =
    (ai, bi, aj, bj, extent_i, extent_j, taps)`` with ``taps`` a tuple of
    ``(di, dj, hex_tap_index)``; input row read by a tap is
    ``ai*yq + bi + di`` for class step ``yq`` (columns analogous).
    """
    s, r = stride, radius
    ks = 2 * r - 1
    k_h, k_w = ks, 4 * r - 3
    p = r - 1
    # canonical size: large enough for >= 2 interior samples per class
    h0 = 8 * s + 4 * r
    w0 = 8 * s + 4 * r
    w1 = 2 * s * w0 - s + 2 + (1 - s % 2)
    h1 = s * h0 - s + 1
    own = -np.ones((h1, w1), np.int64)
    ev = np.arange(0, h0, 2)
    od = np.arange(1, h0, 2)
    for delta in (0, 1):
        col0 = offset * s + delta
        rr = 2 * s * np.arange(len(ev))
        cc = col0 + 2 * s * np.arange(w0)
        own[np.ix_(rr, cc)] = ev[:, None] * w0 + np.arange(w0)[None]
        col1 = (1 - offset) * s + delta
        if len(od):
            rr = s + 2 * s * np.arange(len(od))
            cc = col1 + 2 * s * np.arange(w0)
            own[np.ix_(rr, cc)] = od[:, None] * w0 + np.arange(w0)[None]
    own = np.pad(own, ((p, p), (2 * p, 2 * p)), constant_values=-1)
    wmap = -np.ones((k_h, k_w), np.int64)
    for (i, t, ln, start) in _hex_kernel_rows(r):
        wmap[i, t:t + (ln - 1) * 2 + 1:2] = np.arange(start, start + ln)
    views = (own[:, 1:own.shape[1] - s], own[s:, s + 1:])

    def fit_affine(pairs):
        """Exact affine fit q -> v over the (q, v) pairs; assert."""
        (q0, v0), (q1, v1) = pairs[0], pairs[-1]
        assert q1 != q0
        a, rem = divmod(v1 - v0, q1 - q0)
        assert rem == 0
        b = v0 - a * q0
        assert all(v == a * q + b for q, v in pairs)
        return a, b

    plans = []
    for view in views:
        H = (view.shape[0] - k_h) // 2 + 1
        W = (view.shape[1] - k_w) // 2 + 1
        cls = {}
        for ya in range(s):
            for za in range(s):
                recs = []
                for yq, y in enumerate(range(ya, H, s)):
                    for zq, z in enumerate(range(za, W, s)):
                        win = view[2 * y:2 * y + k_h, 2 * z:2 * z + k_w]
                        tm = {}
                        for ki in range(k_h):
                            for kj in range(k_w):
                                if wmap[ki, kj] < 0:
                                    continue
                                o = win[ki, kj]
                                if o >= 0:
                                    tm[(ki, kj)] = (o // w0, o % w0)
                        recs.append((yq, zq, tm))
                keysets = [frozenset(t) for (_, _, t) in recs]
                full = max(keysets, key=len, default=frozenset())
                if not full:
                    cls[(ya, za)] = None
                    continue
                interior = [rec for rec, k_ in zip(recs, keysets)
                            if k_ == full]
                ai = aj = None
                tap_affine = {}
                for tap in sorted(full):
                    ipairs = sorted({(yq, tm[tap][0])
                                     for (yq, _, tm) in interior})
                    jpairs = sorted({(zq, tm[tap][1])
                                     for (_, zq, tm) in interior})
                    # rows depend only on yq, cols only on zq
                    assert len({q for q, _ in ipairs}) == len(ipairs)
                    assert len({q for q, _ in jpairs}) == len(jpairs)
                    a_i, b_i = fit_affine(ipairs)
                    a_j, b_j = fit_affine(jpairs)
                    if ai is None:
                        ai, aj = a_i, a_j
                    assert (a_i, a_j) == (ai, aj)
                    tap_affine[tap] = (b_i, b_j)
                bi = min(v[0] for v in tap_affine.values())
                bj = min(v[1] for v in tap_affine.values())
                taps = tuple(
                    (v[0] - bi, v[1] - bj, int(wmap[tap]))
                    for tap, v in sorted(tap_affine.items()))
                ext_i = 1 + max(t[0] for t in taps)
                ext_j = 1 + max(t[1] for t in taps)
                cls[(ya, za)] = (ai, bi, aj, bj, ext_i, ext_j, taps)
        plans.append(cls)
    return tuple(plans)


def _phase_sizes(h, w, radius, stride):
    """(H, W) of the two conv phases of the transposed conv's output."""
    s, r = stride, radius
    k_h, k_w = 2 * r - 1, 4 * r - 3
    p = r - 1
    h1p = s * h - s + 1 + 2 * p
    wv = 2 * s * w - s + 2 + (1 - s % 2) + 4 * p - 1 - s
    return (((h1p - k_h) // 2 + 1, (wv - k_w) // 2 + 1),
            ((h1p - s - k_h) // 2 + 1, (wv - k_w) // 2 + 1))


def _hex_conv_transpose2d_phase(x, kernel, bias, *, even_odd_offset: int,
                                radius: int, stride: int, groups: int):
    """Phase-decomposed transposed conv: per output-phase class, one dense
    stride-``(ai, aj)`` conv directly on the input with the sub-kernel of
    the taps that hit data (see :func:`_transpose_phase_plan`); classes
    interleave into the two conv phases, which merge as usual."""
    b_, c, h, w = x.shape
    s = stride
    o = kernel.shape[0]
    plans = _transpose_phase_plan(radius, stride, even_odd_offset)
    dt = kernel.dtype
    outs = []
    for cp, (H, W) in enumerate(_phase_sizes(h, w, radius, stride)):
        Hm, Wm = -(-H // s), -(-W // s)
        subs = []
        for ya in range(s):
            for za in range(s):
                info = plans[cp].get((ya, za))
                Hq = len(range(ya, H, s))
                Wq = len(range(za, W, s))
                if info is None or Hq == 0 or Wq == 0:
                    subs.append(x.new_zeros((b_, o, Hm, Wm), dtype=dt))
                    continue
                ai, bi, aj, bj, ext_i, ext_j, taps = info
                subk = kernel.new_zeros((o, c // groups, ext_i, ext_j))
                for di, dj, tap in taps:
                    subk[:, :, di, dj] += kernel[:, :, tap]
                r0, r1 = bi, ai * (Hq - 1) + bi + ext_i
                c0, c1 = bj, aj * (Wq - 1) + bj + ext_j
                pt, pb = max(0, -r0), max(0, r1 - h)
                pl_, pr = max(0, -c0), max(0, c1 - w)
                xp = x
                if pt or pb or pl_ or pr:
                    xp = tF.pad(x, (pl_, pr, pt, pb))
                xs = xp[:, :, r0 + pt:r1 + pt, c0 + pl_:c1 + pl_]
                with span("hygrid.conv_transpose.subconv"):
                    sub = _conv(xs.to(dt), subk, (ai, aj), groups)
                if sub.shape[2] < Hm or sub.shape[3] < Wm:
                    sub = tF.pad(sub, (0, Wm - sub.shape[3],
                                       0, Hm - sub.shape[2]))
                subs.append(sub)
        arr = torch.stack(subs).reshape(s, s, b_, o, Hm, Wm)
        arr = arr.permute(2, 3, 4, 0, 5, 1).reshape(b_, o, Hm * s, Wm * s)
        outs.append(arr[:, :, :H, :W])
    return _merge_phases(outs[0], outs[1], bias)


def _merge_phases_nhwc(ev, od, bias):
    """``functional._merge_phases`` on channels-last tensors, as a
    stack+reshape interleave (``hygrid_tpu``'s form)."""
    pad_width = ev.shape[2] - od.shape[2]
    if pad_width > 0:
        ev = ev[:, :, :-pad_width]
    elif pad_width < 0:
        od = od[:, :, :pad_width]
    he, ho = ev.shape[1], od.shape[1]
    n = max(he, ho)
    if he < n:
        ev = tF.pad(ev, (0, 0, 0, 0, 0, n - he))
    if ho < n:
        od = tF.pad(od, (0, 0, 0, 0, 0, n - ho))
    out = torch.stack([ev, od], dim=2).reshape(
        ev.shape[0], 2 * n, ev.shape[2], ev.shape[3])[:, :he + ho]
    if bias is not None:
        out = out + bias
    return out


def _mm_f32(x, m):
    """``x @ m`` over the last axis, accumulated and returned in float32 for
    16-bit inputs (``hygrid_tpu``'s ``_mm_lane``, preferred_element_type
    float32)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x, m = x.float(), m.float()
    return torch.matmul(x, m)


def _hex_conv_transpose2d_matmul(xl, kernel, bias, *, even_odd_offset: int,
                                 radius: int, stride: int, groups: int):
    """Phase-decomposed transposed conv as one tap matmul + reshape
    interleaves, channels-last: the input against all distinct surviving
    taps in one matmul ``(B,H,W,C) @ (C, T*O)``, every class as shifted
    strided reads of that product summed, classes and conv phases
    interleaved by stack+reshape.  ``xl``: (B, H, W, C); returns
    (B, H', W', O)."""
    b_, h, w, c = xl.shape
    s = stride
    o = kernel.shape[0]
    cg, og = c // groups, o // groups
    sizes = _phase_sizes(h, w, radius, stride)
    plans = _transpose_phase_plan(radius, stride, even_odd_offset)
    dt = kernel.dtype

    used = sorted({t for cls in plans for info in cls.values()
                   if info is not None for _, _, t in info[6]})
    tap_pos = {t: n for n, t in enumerate(used)}
    nt = len(used)
    if groups == 1:
        wcat = torch.cat([kernel[:, :, t].T for t in used], dim=1)
        y = _mm_f32(xl.to(dt), wcat.to(dt))
    else:
        gs = []
        for g in range(groups):
            wg = torch.cat([kernel[g * og:(g + 1) * og, :, t].T
                            for t in used], dim=1)
            gs.append(_mm_f32(xl[..., g * cg:(g + 1) * cg].to(dt),
                              wg.to(dt)).reshape(b_, h, w, nt, og))
        y = torch.cat(gs, -1)
    y = y.reshape(b_, h, w, nt, o)

    # one pad of the (input-sized) tap product covers every class's
    # shifted slice range
    pt = pb = pl_ = pr = 0
    for cp, (H, W) in enumerate(sizes):
        for ya in range(s):
            for za in range(s):
                info = plans[cp].get((ya, za))
                Hq = len(range(ya, H, s))
                Wq = len(range(za, W, s))
                if info is None or Hq == 0 or Wq == 0:
                    continue
                ai, bi, aj, bj, ext_i, ext_j, _ = info
                pt = max(pt, -bi)
                pb = max(pb, ai * (Hq - 1) + bi + ext_i - h)
                pl_ = max(pl_, -bj)
                pr = max(pr, aj * (Wq - 1) + bj + ext_j - w)
    if pt or pb or pl_ or pr:
        y = tF.pad(y, (0, 0, 0, 0, pl_, pr, pt, pb))

    outs = []
    for cp, (H, W) in enumerate(sizes):
        Hm, Wm = -(-H // s), -(-W // s)
        rows_cls = []
        for ya in range(s):
            cols_cls = []
            for za in range(s):
                info = plans[cp].get((ya, za))
                Hq = len(range(ya, H, s))
                Wq = len(range(za, W, s))
                if info is None or Hq == 0 or Wq == 0:
                    cols_cls.append(y.new_zeros((b_, Hm, Wm, o)))
                    continue
                ai, bi, aj, bj, ext_i, ext_j, taps = info
                acc = None
                for di, dj, tap in taps:
                    rr = slice(bi + di + pt, bi + di + pt
                               + ai * (Hq - 1) + 1, ai)
                    cc = slice(bj + dj + pl_, bj + dj + pl_
                               + aj * (Wq - 1) + 1, aj)
                    v = y[:, rr, cc, tap_pos[tap], :]
                    acc = v if acc is None else acc + v
                if acc.shape[1] < Hm or acc.shape[2] < Wm:
                    acc = tF.pad(acc, (0, 0, 0, Wm - acc.shape[2],
                                       0, Hm - acc.shape[1]))
                cols_cls.append(acc)
            row = (cols_cls[0] if s == 1 else
                   torch.stack(cols_cls, dim=3).reshape(b_, Hm, Wm * s, o))
            rows_cls.append(row)
        arr = (rows_cls[0] if s == 1 else
               torch.stack(rows_cls, dim=2).reshape(b_, Hm * s, Wm * s, o))
        outs.append(arr[:, :H, :W, :])
    return _merge_phases_nhwc(outs[0], outs[1], bias)


def hex_pixel_shuffle(x, upscale_factor: int, device="cuda"):
    """Sub-pixel hex upsampling (archive codes:68-126): C*u^2 channels ->
    C channels at u-times the hex resolution, channels scattered onto the
    hex-kernel footprint of each cell."""
    x = _tensor(x, device=device)
    u = upscale_factor
    b, cin, h, w = x.shape
    if cin % (u * u):
        raise ValueError("channels must be divisible by upscale_factor^2")
    cout = cin // (u * u)
    odd_h = h // 2
    even_h = h - odd_h
    out_h = u * h + u - 1
    out_w = u * w + u // 2
    out = x.new_zeros((b, cout, out_h, out_w * 2 + 1))
    type1_off = 1 if u % 2 == 0 else -1

    n = 0
    for i in range(2 * u - 1):
        t = abs(1 + i - u)
        for k in range(u - t):
            chunk = x[:, n * cout:(n + 1) * cout]
            ev = chunk[:, :, ::2, :]
            od = chunk[:, :, 1::2, :]
            for base in (1 + t + 2 * k, 1 + t + 2 * k + type1_off):
                out[:, :, i:i + 2 * u * (even_h - 1) + 1:2 * u,
                    base:base + (w - 1) * 2 * u + 1:2 * u] = ev
            for base in (u + 1 + t + 2 * k, u + 1 + t + 2 * k + type1_off):
                if od.shape[2] > 0:
                    out[:, :, u + i:u + i + 2 * u * (odd_h - 1) + 1:2 * u,
                        base:base + (w - 1) * 2 * u + 1:2 * u] = od
            n += 1
    if u < 2:
        raise ValueError("upscale_factor must be >= 2 (the archive's crop "
                         "degenerates to an empty tensor for u=1)")
    hex_out, _ = type1_to_heximage(out, 0)
    # archive crop: [u-1 : -u+1, u//2 : -u//2] where the last bound parses
    # as (-u)//2 (unary minus binds first): 1 wider crop for odd u
    return hex_out[:, :, u - 1:-u + 1, u // 2:(-u) // 2]


# ------------------------------- poolings ----------------------------------

def pixel_even_row_quadtree_unfold(x):
    """(codes:637-644): 4 quadtree leaves per cell -> (..., 4)."""
    leaves = (x[:, :, 1:-1:4, 0:-1:2], x[:, :, 2::4, 0:-1:2],
              x[:, :, 1:-1:4, 1::2], x[:, :, 0:-2:4, 1::2])
    hh = min(a.shape[2] for a in leaves)
    ww = min(a.shape[3] for a in leaves)
    return torch.stack([a[:, :, :hh, :ww] for a in leaves], dim=4)


def _interleave_rows(even, odd, dtype):
    """Rows of ``even`` at 0, 2, ... and of ``odd`` at 1, 3, ... (the
    pooled (B, C, H, W, K) window stacks of the two row phases)."""
    hh = even.shape[2] + odd.shape[2]
    pooled = even.new_zeros((even.shape[0], even.shape[1], hh, even.shape[3],
                             even.shape[4]), dtype=dtype)
    pooled[:, :, ::2] = even[:, :, :(hh + 1) // 2]
    pooled[:, :, 1::2] = odd[:, :, :hh // 2]
    return pooled


def _trim_widths(even, odd):
    pad_w = even.shape[3] - odd.shape[3]
    if pad_w > 0:
        even = even[:, :, :, :-pad_w]
    elif pad_w < 0:
        odd = odd[:, :, :, :pad_w]
    return even, odd


def quadtree_hex_pooling(x, method: str, offset: int = 0, device="cuda"):
    """Quadtree pooling (archive codes:494-532): pool the 4 child cells of
    a coarser hex hierarchy level."""
    x = _tensor(x, device=device)
    reduce_fn = _reduction(method)
    even = pixel_even_row_quadtree_unfold(x[:, :, offset:, :-1])
    odd = pixel_even_row_quadtree_unfold(x[:, :, offset + 2:, 1:])
    even, odd = _trim_widths(even, odd)
    return reduce_fn(_interleave_rows(even, odd, x.dtype))


def pixel_even_row_dimond_unfold_1(x, d: int, stride: Optional[int] = None,
                                   offset: int = 0):
    """Diamond-footprint unfold over a type-1 image (codes:645-675)."""
    if stride is None:
        stride = d
    height = int(np.ceil((x.shape[2] + 1 - 2 * d + 1) / (2 * stride)))
    width = int(np.ceil(int((x.shape[3] - 1) / 2 + 1 - d) / stride))
    pieces = []
    for i in range(2 * d - 1):
        t = abs(1 + i - d)
        for k in range(d - t):
            c0 = 1 + t + 2 * k
            pieces.append(x[:, :,
                            i:i + 2 * stride * (height - 1) + 1:2 * stride,
                            c0:c0 + (width - 1) * 2 * stride + 1:2 * stride])
    return torch.stack(pieces, dim=4)


def diamond_hex_pooling(x, method: str, kernelsize: int = 2,
                        stride: Optional[int] = None, padding: int = 0,
                        even_odd_offset: int = 0,
                        padding_mode: str = "constant", padding_value=0,
                        device="cuda"):
    """Diamond pooling (archive ``Dimond_HexPooling``, codes:533-585)."""
    x = _tensor(x, device=device)
    reduce_fn = _reduction(method)
    if stride is None:
        stride = kernelsize
    off = (even_odd_offset + padding) % 2
    x = pad2d(x, padding, padding_mode, padding_value)
    t1 = heximage_to_type1(x, off)
    even = pixel_even_row_dimond_unfold_1(t1, kernelsize, stride, off)
    odd = pixel_even_row_dimond_unfold_1(t1[:, :, stride:, stride:],
                                         kernelsize, stride, off)
    even, odd = _trim_widths(even, odd)
    return reduce_fn(_interleave_rows(even, odd, x.dtype))


def pixel_even_row_square_unfold(x, d: int, stride: Optional[int] = None):
    """(codes:712-739): fxf windows of even rows -> (..., f^2)."""
    if stride is None:
        stride = d
    if d % 2 or stride % 2:
        raise ValueError("factor d and stride must be even")
    height = int(np.ceil((x.shape[2] - d + 1) / (2 * stride)))
    width = int(np.ceil(x.shape[3] - d + 1) / stride)
    pieces = []
    for i in range(d):
        for j in range(d):
            pieces.append(x[:, :,
                            i:i + 2 * stride * (height - 1) + 1:2 * stride,
                            j:j + stride * (width - 1) + 1:stride])
    return torch.stack(pieces, dim=4)


def hex_to_square_original_resolution(x, kernel=None, *,
                                      even_odd_offset: int = 0,
                                      padding: int = 0,
                                      padding_mode: str = "constant",
                                      padding_value=0, device="cuda"):
    """Same-resolution hex->rect transform via 2x2 diamond blending
    (archive codes:587-636); odd rows are re-blended from their diamond
    neighbourhood, even rows pass through."""
    x = _tensor(x, kernel, device)
    kernel = (diamond_weight(x.shape[1], 2, device=x.device) if kernel is None
              else _weights(kernel, x))
    off = (even_odd_offset + padding) % 2
    x = pad2d(x, padding, padding_mode, padding_value)
    t1 = heximage_to_type1(x, off)
    even = pixel_even_row_dimond_unfold_1(t1, 2, 1, 0)
    tmp = torch.einsum("bchwk,ck->bchw", even.to(kernel.dtype), kernel)
    result = x.to(tmp.dtype).clone()
    result[:, :, 1:-1:2, 1:] = tmp
    return result[:, :, :, 1:]


# --------------------------- im2col reference ------------------------------

def hex_im2col(x, even_odd_offset: int, kernel_radius: int,
               stride: int = 1, padding: int = 0, device="cuda"):
    """Hex neighbourhood unfold (archive codes:366-419, vectorised).

    Returns (B, out_h*out_w, kernelnum*C) matching the archive's loop
    semantics (including the parity-dependent kernel shape,
    ``dl = |h + offset + r - 1 - padding| & 1``).
    """
    x = pad2d(_tensor(x, device=device), padding)
    b, c, h, w = x.shape
    r = kernel_radius
    ks = 2 * r - 1
    out_w = (w - ks) // stride + 1
    patches = []
    for h0 in range(0, h - ks + 1, stride):
        dl = abs(h0 + even_odd_offset + r - 1 - padding) & 1
        row_vecs = []
        for l in range(ks):
            t = abs(l + 1 - r)
            ln = ks - t
            c0 = t // 2 + dl * (t & 1)
            for w0 in range(ln):
                row_vecs.append(x[:, :, h0 + l,
                                  c0 + w0:c0 + w0 + (out_w - 1) * stride + 1:stride])
        # the archive flattens channel-major, (C, kernelnum), so lay out
        # as (B, out_w, C*kn)
        stackd = torch.stack(row_vecs, dim=1)      # (B, kn, C, out_w)
        patches.append(stackd.permute(0, 3, 2, 1).reshape(b, out_w, -1))
    return torch.cat(patches, dim=1)               # (B, out_h*out_w, C*kn)


def im2col_hex_conv2d(x, weight, bias=None, *, even_odd_offset: int = 0,
                      kernel_radius: int, stride: int = 1, padding: int = 0,
                      device="cuda"):
    """im2col-based hex conv (archive codes:277-364): unfold then one
    matmul.  ``weight``: (kernelnum*C, O) as in the archive."""
    x = _tensor(x, weight, device)
    weight = _weights(weight, x)
    b, c, h, w = x.shape
    ks = 2 * kernel_radius - 1
    out_w = (w - ks + 2 * padding) // stride + 1
    out_h = (h - ks + 2 * padding) // stride + 1
    cols = hex_im2col(x, even_odd_offset, kernel_radius, stride, padding)
    out = cols.to(weight.dtype) @ weight
    if bias is not None:
        out = out + _weights(bias, x)
    return out.permute(0, 2, 1).reshape(b, -1, out_h, out_w)
