"""Plain PyTorch of the hex-lattice operations the benchmark's models use.

This is the yardstick the program is held to, written from the lattice's
definition and kept apart from the program: it imports nothing of
``hygrid_tpu_torch`` (nor JAX) and takes only the benchmark's own inputs and
weights.  Everything computes in float32 on NCHW tensors.  On CUDA the
caller turns TF32 off (:func:`float32_exact`), so a float32 product is a
float32 product.

Storage is the brick wall with offset 0: hex row ``i`` is shifted right by
half a cell when ``i`` is odd.  A hex kernel of radius ``r`` holds the
``3r^2 - 3r + 1`` cells within ``r - 1`` steps of its centre, flat, rows top
to bottom and cells left to right.

``q`` (a :class:`Rounding` or None) rounds the operands of every product and
the stored activations to a lower precision: the benchmark's control, the
reference computed in the precision just below the one the configuration
states.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as tF

__all__ = ["Rounding", "float32_exact", "rect_to_hex_plan", "apply_plan",
           "hex_taps", "hex_conv", "hex_conv_transpose2", "hex_maxpool2",
           "group_norm", "crop_or_pad", "linear", "xent", "AdamW"]


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN inside the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude to 448)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


_ROUND = {"tf32": _round_tf32,
          "bf16": lambda t: t.to(torch.bfloat16).float(),
          "fp8": _round_fp8}


class _RoundFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x if fwd is None else fwd(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.bwd is None else ctx.bwd(g)), None, None


class Rounding:
    """A lower precision: ``"tf32"`` rounds the operands of each product
    (and the gradients entering the backward's products) and keeps float32
    activations; ``"bf16"`` and ``"fp8"`` also store the activations so."""

    def __init__(self, kind: str):
        if kind not in _ROUND:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind, self._r = kind, _ROUND[kind]

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFn.apply(t, self._r, self._r)

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFn.apply(t, None if self.kind == "tf32" else self._r,
                              self._r)


def _op(q, t):
    return t if q is None else q.op(t)


def _store(q, t):
    return t if q is None else q.store(t)


# ------------------------------------------------------------ resampling

def rect_to_hex_plan(h: int, w: int, h1: int, w1: int):
    """Bilinear samples of a rect ``(h, w)`` image at the hex grid
    ``(h1, w1)``: the grid spans the image's outer box widened by half a
    pixel on each side of the row axis (``h1`` rows over ``[-h/2, h/2]``,
    ``w1`` columns over ``[-(w/2 + 1/2), w/2 + 1/2]``, image-centred), each
    point blended from the pixels at ``(trunc(i), trunc(j))`` and the three
    after it, a pixel outside the image weighing 0.  Returns ``idx`` int64
    and ``weight`` float32 numpy arrays of shape ``(4, h1 * w1)``."""
    i_ = np.linspace(-h / 2, h / 2, h1)[:, None] + (h - 1) * 0.5
    j_ = np.linspace(-(w / 2 + 0.5), w / 2 + 0.5, w1)[None, :] + (w - 1) * 0.5
    i_, j_ = np.broadcast_arrays(i_, j_)
    i0, j0 = np.trunc(i_).astype(np.int64), np.trunc(j_).astype(np.int64)
    fi, fj = i_ - i0, j_ - j0
    idx, wts = [], []
    for a, wa in ((0, 1 - fi), (1, fi)):
        for b, wb in ((0, 1 - fj), (1, fj)):
            ii, jj = i0 + a, j0 + b
            inside = (ii >= 0) & (ii < h) & (jj >= 0) & (jj < w)
            idx.append((np.clip(ii, 0, h - 1) * w + np.clip(jj, 0, w - 1)))
            wts.append(wb * wa * inside)
    return (np.stack(idx).reshape(4, -1),
            np.stack(wts).reshape(4, -1).astype(np.float32))


def apply_plan(img: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor,
               out_hw) -> torch.Tensor:
    """``(B, C, H, W)`` -> ``(B, C, *out_hw)``, ``out = sum_k wts[k] *
    img[idx[k]]`` in float32."""
    flat = img.float().flatten(2)
    out = sum(flat[:, :, idx[k]] * wts[k] for k in range(idx.shape[0]))
    return out.reshape(*img.shape[:2], *out_hw)


# ------------------------------------------------------------ convolution

def hex_taps(radius: int, parity: int):
    """``[(dr, dc)]`` of a hex kernel in its flat order, for an output cell
    in a row of the given parity (1: a shifted row): the cells of row
    ``i + dr`` whose centres lie within ``radius - 1`` of the cell's."""
    r = radius - 1
    taps = []
    for dr in range(-r, r + 1):
        shift = ((parity + dr) % 2 - parity) * 0.5
        lo = math.ceil(-(r - abs(dr) / 2) - shift)
        taps += [(dr, lo + m) for m in range(2 * r + 1 - abs(dr))]
    return taps


def _interleave_rows(even: torch.Tensor, odd: torch.Tensor, h: int):
    out = even.new_zeros(*even.shape[:2], h, even.shape[-1])
    out[:, :, 0::2] = even
    out[:, :, 1::2] = odd
    return out


def hex_conv(x: torch.Tensor, kernel: torch.Tensor, radius: int, q=None):
    """Stride-1 'same' hex convolution (correlation, zero outside the
    image) of ``(B, C, H, W)`` with flat weights ``(O, C, taps)``."""
    b, c, h, w = x.shape
    p = radius - 1
    xp = tF.pad(_op(q, x), (p, p, p, p))
    kernel = _op(q, kernel)
    parts = []
    for parity in (0, 1):
        n = (h - parity + 1) // 2
        cols = [xp[:, :, p + parity + dr: p + parity + dr + 2 * n - 1: 2,
                   p + dc: p + dc + w] for dr, dc in hex_taps(radius, parity)]
        parts.append(torch.einsum("oct,bcthw->bohw", kernel,
                                  torch.stack(cols, 2)))
    return _interleave_rows(*parts, h)


def _type1_kernel(kernel: torch.Tensor, radius: int) -> torch.Tensor:
    """Flat hex weights on the type-1 grid, where a hex row's cells lie two
    columns apart and a row ``t`` steps from the centre starts ``t`` columns
    in: ``(O, C, 2r - 1, 4r - 3)``."""
    ks = 2 * radius - 1
    out = kernel.new_zeros(*kernel.shape[:2], ks, 2 * ks - 1)
    start = 0
    for i in range(ks):
        t = abs(i - radius + 1)
        n = ks - t
        out[:, :, i, t: t + 2 * n - 1: 2] = kernel[:, :, start: start + n]
        start += n
    return out


def hex_conv_transpose2(x: torch.Tensor, kernel: torch.Tensor, radius: int,
                        q=None) -> torch.Tensor:
    """Stride-2 transposed hex convolution of the HexUNet decoder (the
    archive's definition): each input cell is written onto two adjacent
    columns of a type-1 canvas twice as fine, even input rows at canvas rows
    ``0, 4, ...`` and columns ``4j, 4j + 1``, odd rows at ``2, 6, ...`` and
    ``4j + 2, 4j + 3``; the canvas is padded by ``r - 1`` rows and ``2(r -
    1)`` columns, and the type-1 kernel runs over it at stride 2 on both row
    phases, whose rows interleave.  ``(B, C, h, w)`` with ``(O, C, taps)``
    -> ``(B, O, 2h - 1, 2w - 1)`` for radius 2."""
    b, c, h, w = x.shape
    p = radius - 1
    x = _op(q, x)
    canvas = x.new_zeros(b, c, 2 * h - 1, 4 * w + 1)
    ev, od = x[:, :, 0::2], x[:, :, 1::2]
    for delta in (0, 1):
        canvas[:, :, 0::4, delta: delta + 4 * w - 3: 4] = ev
        canvas[:, :, 2::4, 2 + delta: 2 + delta + 4 * w - 3: 4] = od
    canvas = tF.pad(canvas, (2 * p, 2 * p, p, p))
    weight = _type1_kernel(_op(q, kernel), radius)
    even = tF.conv2d(canvas[:, :, :, 1:-2], weight, stride=2)
    odd = tF.conv2d(canvas[:, :, 2:, 3:], weight, stride=2)
    wo = min(even.shape[-1], odd.shape[-1])
    he, ho = even.shape[2], odd.shape[2]
    return _interleave_rows(even[..., :wo], odd[:, :, :, :wo], he + ho)


def hex_maxpool2(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 hex max-pool: window ``(gi, gj)`` covers rows ``2 gi + {0,
    1}`` and columns ``(gi % 2) + 2 gj + {0, 1}``; ``(B, C, H, W)`` ->
    ``(B, C, H // 2, (W - 1) // 2)``."""
    h, w = x.shape[-2:]
    hn, wn = (h - 2) // 2 + 1, (w - 1) // 2
    gi = torch.arange(hn, device=x.device)
    gj = torch.arange(wn, device=x.device)
    vals = []
    for a in (0, 1):
        for bb in (0, 1):
            rows = (2 * gi + a)[:, None]
            cols = (gi % 2)[:, None] + 2 * gj[None, :] + bb
            vals.append(x[:, :, rows, cols])
    return torch.stack(vals).amax(0)


def group_norm(x, groups: int, gamma, beta, eps: float = 1e-5):
    """Per-sample GroupNorm, float32 statistics, biased variance."""
    return tF.group_norm(x, groups, gamma, beta, eps)


def crop_or_pad(x: torch.Tensor, hw) -> torch.Tensor:
    """Cut ``(B, C, H, W)`` to ``hw`` from the top left, then zero-pad it to
    ``hw`` at the bottom and right."""
    x = x[:, :, :hw[0], :hw[1]]
    return tF.pad(x, (0, hw[1] - x.shape[-1], 0, hw[0] - x.shape[-2]))


def linear(x, weight, bias, q=None):
    return _op(q, x) @ _op(q, weight).t() + bias


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed softmax cross-entropy; class axis 1 (``(B, K)`` or ``(B, K,
    h, w)`` against ``(B,)`` or ``(B, h, w)`` ids)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, labels.long().unsqueeze(1)).sum()


class AdamW:
    """optax.adamw's update on a dict of float32 tensors: ``m = b1 m + (1 -
    b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr (m_hat / (sqrt(v_hat) +
    eps) + wd p)`` with the bias corrections of step ``t``."""

    def __init__(self, params: dict, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 wd=1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            p.sub_(self.lr * (u + self.wd * p))
