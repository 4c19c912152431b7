"""Plain float32 HexDeepLabV3: DeepLabv3 at output stride 16 (arXiv:1706.05587,
sections 3.3 and 4) on a ResNet-50 bottleneck backbone (arXiv:1512.03385,
Table 1), written from the lattice's definition, apart from the program.

``params`` holds the benchmark's weights under the model's public names:
``stem.*``; ``layer{s}.{i}.conv{1,2,3}.*`` and ``.proj.*`` (a stride-1 conv's
``kernel_0``, ``gn_scale_0``, ``gn_bias_0``; a strided one's ``kernel``,
``gn_scale``, ``gn_bias``); ``aspp.branch0``, ``aspp.rates.{k}``,
``aspp.pool``, ``aspp.project``; ``classifier.weight``, ``classifier.bias``.

The hex conv here is the lattice's: an output cell's taps are the cells
within ``radius - 1`` steps of its centre, ``dilation`` times as far; at
stride 2 output cell ``(o, j)`` is centred on input cell ``(2 o, 2 j + o %
2)``, which lies on an even row, as the output lattice scaled by two lies
on the input's; the image is zero outside (padding ``dilation (radius -
1)``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from . import hexlib as H


def dilated_taps(radius: int, dilation: int, parity: int):
    """``[(dr, dc)]`` of a hex kernel dilated by ``dilation``, flat order
    (rows top to bottom, cells left to right), around a centre on a row of
    ``parity`` (1: shifted right by half a cell): kernel row ``k`` lies
    ``k d`` rows away and its cells ``d`` cells apart, centred on the
    centre's horizontal position."""
    r, d, taps = radius - 1, dilation, []
    for k in range(-r, r + 1):
        dr = k * d
        shift = 0.5 * (parity - (parity + dr) % 2)
        for m in range(2 * r + 1 - abs(k)):
            dc = d * (m - r + abs(k) / 2) + shift
            taps.append((dr, int(round(dc))))
    return taps


def hex_conv(x, kernel, radius: int, stride: int = 1, dilation: int = 1,
             q=None):
    """Hex convolution (correlation) of ``(B, C, H, W)`` with flat weights
    ``(O, C, taps)`` at stride 1 or 2, zero outside the image: ``(B, O, H,
    W)`` at stride 1; at stride 2 the ``(H - 1) // 2 + 1`` rows and ``(W -
    2) // 2 + 1`` columns whose centres lie in the image."""
    b, c, h, w = x.shape
    s, p = stride, dilation * (radius - 1)
    ho = h if s == 1 else (h - 1) // 2 + 1
    wo = w if s == 1 else (w - 2) // 2 + 1
    xp = tF.pad(H._op(q, x), (p, p, p, p))
    kernel = H._op(q, kernel)
    out = xp.new_zeros((b, kernel.shape[0], ho, wo))
    for ph in (0, 1):
        rows = torch.arange(ph, ho, 2, device=x.device)
        if not len(rows):
            continue
        centre_r = s * rows + p
        centre_c = s * torch.arange(wo, device=x.device) + (ph if s == 2
                                                             else 0) + p
        parity = (s * ph) % 2
        win = torch.stack([xp[:, :, (centre_r + dr)[:, None],
                              (centre_c + dc)[None, :]]
                           for dr, dc in dilated_taps(radius, dilation,
                                                      parity)], 2)
        out[:, :, ph::2] = torch.einsum("oct,bcthw->bohw", kernel, win)
    return out


def hex_maxpool3(x):
    """The 3 x 3 stride-2 max-pool of the stem (ResNet's, on the brick
    lattice): one cell of zeros around the image, window ``(gi, gj)`` over
    rows ``2 gi + {0, 1, 2}`` and columns ``gi % 2 + 2 gj + {0, 1, 2}``.
    Its input is a ReLU's, so the zeros never win over a cell."""
    xp = tF.pad(x, (1, 1, 1, 1))
    h, w = xp.shape[-2:]
    hn, wn = (h - 3) // 2 + 1, (w - 1) // 2
    gi = torch.arange(hn, device=x.device)
    gj = torch.arange(wn, device=x.device)
    vals = [xp[:, :, (2 * gi + a)[:, None],
               (gi % 2)[:, None] + 2 * gj[None, :] + bb]
            for a in range(3) for bb in range(3)]
    return torch.stack(vals).amax(0)


# ------------------------------------------------------- the hex resample

def hexresize_plan(h: int, w: int, h1: int, w1: int):
    """HyGrid's ``hexresize`` with linear interpolation, from a hex ``(h,
    w)`` image to ``(h1, w1)``: the output grid spans the source's cell
    centres (rows over ``[-(h/2 - 1/2), h/2 - 1/2]``, columns over
    ``[-((w + 1/2)/2 - 1/2), (w + 1/2)/2 - 1/2]``, image-centred, no half
    shift on odd rows), each point blended from the three cells of the
    lattice triangle around it by their barycentric weights, a cell outside
    the image weighing 0.  Returns ``idx`` int64 and ``weight`` float32
    numpy arrays of shape ``(3, h1 * w1)``."""
    gx, gy = np.meshgrid(np.linspace(-(h / 2 - 0.5), h / 2 - 0.5, h1),
                         np.linspace(-((w + 0.5) / 2 - 0.5),
                                     (w + 0.5) / 2 - 0.5, w1), indexing="ij")
    # oblique (affine) coordinates: i down the rows, j along the 60-degree
    # axis; the cell (i, j) of the oblique grid is storage cell (i, j -
    # trunc((i + 1) / 2)) of the brick wall
    i_ = gx + (h - 1) * 0.5
    j_ = 0.5 * i_ + gy + (w - 0.5) * 0.5
    i0, j0 = np.trunc(i_).astype(np.int64), np.trunc(j_).astype(np.int64)
    fi, fj = i_ - i0, j_ - j0
    upper = fi > fj       # the triangle with two cells on the next row

    def storage(i, j):
        return i, j - np.trunc((i + 1) / 2.0).astype(np.int64)

    def centre(i, j):     # Cartesian centre of oblique cell (i, j)
        return i - (h - 1) / 2.0, j - i / 2.0 - (w - 0.5) / 2.0

    up = upper.astype(np.float64)
    corners = [(i0, j0), (i0 + upper, j0 + 1 - upper), (i0 + 1, j0 + 1)]
    pts = [centre(i0, j0), centre(i0 + up, j0 + 1 - up),
           centre(i0 + 1.0, j0 + 1.0)]

    def area(a, b):
        return 0.5 * np.abs((gx - a[0]) * (gy - b[1])
                            - (gy - a[1]) * (gx - b[0]))

    s = [area(pts[1], pts[2]), area(pts[0], pts[2]), area(pts[0], pts[1])]
    total = s[0] + s[1] + s[2]
    idx, wts = [], []
    for (ci, cj), sk in zip(corners, s):
        si, sj = storage(ci, cj)
        inside = (si >= 0) & (si < h) & (sj >= 0) & (sj < w)
        idx.append(np.clip(si, 0, h - 1) * w + np.clip(sj, 0, w - 1))
        wts.append(sk / total * inside)
    return (np.stack(idx).reshape(3, -1),
            np.stack(wts).reshape(3, -1).astype(np.float32))


_PLANS: dict = {}


def hexresize(x, hw, q=None):
    """``(B, C, h, w)`` -> ``(B, C, *hw)`` by :func:`hexresize_plan` (the
    paper's bilinear upsampling of the logits, on the lattice)."""
    key = (*x.shape[-2:], *hw, str(x.device))
    if key not in _PLANS:
        idx, wts = hexresize_plan(*x.shape[-2:], *hw)
        _PLANS[key] = (torch.from_numpy(idx).to(x.device),
                       torch.from_numpy(wts).to(x.device))
    return H.apply_plan(H._op(q, x), *_PLANS[key], tuple(hw))


# ------------------------------------------------------------ the network

def _gn(params, pre, x, groups, suffix, relu, q):
    c = x.shape[1]
    x = H.group_norm(x, math.gcd(groups, c), params[f"{pre}.gn_scale{suffix}"],
                     params[f"{pre}.gn_bias{suffix}"])
    return H._store(q, x.relu() if relu else x)


def conv_gn(params, pre, x, cfg, radius, *, stride=1, dilation=1, relu=True,
            q=None):
    """A conv with GroupNorm and (where ``relu``) ReLU: a strided conv's
    weights are ``{pre}.kernel``, a stride-1 conv's ``{pre}.kernel_0``
    (GroupNorm in place of the paper's batch norm, arXiv:1803.08494)."""
    suffix = "" if stride > 1 else "_0"
    x = hex_conv(x, params[f"{pre}.kernel{suffix}"], radius, stride, dilation,
                 q)
    return _gn(params, pre, x, cfg["groups"], suffix, relu, q)


def bottleneck(params, pre, x, cfg, stride, dilation, q=None):
    """ResNet's bottleneck, the stride on the 3 x 3 conv (as torchvision's
    and timm's resnet50), 1 x 1 convs as 1-tap and 3 x 3 as 7-tap hex
    kernels; the join relu(conv3 + shortcut)."""
    h = conv_gn(params, f"{pre}.conv1", x, cfg, 1, q=q)
    h = conv_gn(params, f"{pre}.conv2", h, cfg, 2, stride=stride,
                dilation=dilation, q=q)
    h = conv_gn(params, f"{pre}.conv3", h, cfg, 1, relu=False, q=q)
    if f"{pre}.proj.kernel" in params or f"{pre}.proj.kernel_0" in params:
        x = conv_gn(params, f"{pre}.proj", x, cfg, 1, stride=stride,
                    relu=False, q=q)
    return H._store(q, (h + x).relu())


def forward(params: dict, x, cfg: dict, q=None):
    """Per-cell logits ``(B, num_classes, H, W)`` of hex images ``(B, C, H,
    W)``."""
    hw = x.shape[-2:]
    r = cfg["stem_radius"]
    x = conv_gn(params, "stem", x, cfg, r, stride=2, q=q)   # 7x7 -> radius 4
    x = hex_maxpool3(x)
    # output stride 16: stage 4's stride becomes dilation 2 on every block
    plan = [(1, 1), (2, 1), (2, 1), (1, 2)]
    for s, (n, (stride, dilation)) in enumerate(zip(cfg["blocks"], plan)):
        for i in range(n):
            x = bottleneck(params, f"layer{s + 1}.{i}", x, cfg,
                           stride if i == 0 else 1, dilation, q)
    # ASPP: 1x1, three 3x3 at the rates, image pooling; no dropout
    outs = [conv_gn(params, "aspp.branch0", x, cfg, 1, q=q)]
    outs += [conv_gn(params, f"aspp.rates.{k}", x, cfg, 2, dilation=rate, q=q)
             for k, rate in enumerate(cfg["aspp_rates"])]
    pooled = H._store(q, x.mean((2, 3), keepdim=True))
    pooled = conv_gn(params, "aspp.pool", pooled, cfg, 1, q=q)
    outs.append(pooled.expand(-1, -1, *x.shape[-2:]))
    x = conv_gn(params, "aspp.project", torch.cat(outs, 1), cfg, 1, q=q)
    logits = H.linear(x.permute(0, 2, 3, 1), params["classifier.weight"],
                      params["classifier.bias"], q).permute(0, 3, 1, 2)
    # the paper's bilinear upsampling to the input, as the lattice's linear
    # resample (HyGrid's hexresize)
    return hexresize(H._store(q, logits), hw, q)
