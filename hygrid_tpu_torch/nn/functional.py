"""Functional hex NN ops (layer L3 core), PyTorch port of
``hygrid_tpu/nn/functional.py``'s convolution and pooling.

Two interchangeable plain convolution implementations over brick-wall
storage:

* ``impl="type1"`` mirrors the reference algorithm: scatter the
  ``3r^2-3r+1`` hex weights into a sparse rect kernel, expand the input to
  the double-width type-1 packing, run two strided convs (even/odd row
  phases), trim and interleave.
* ``impl="direct"`` (default) runs two dense masked convs with window
  stride ``(2s, s)`` on the un-expanded image; the per-kernel-row column
  offsets ``c0`` fold the brick-wall parity.

Both are plain PyTorch (``torch.nn.functional.conv2d``; cuDNN on the
card).  ``impl="pallas"`` runs the single-op conv kernel
(``kernels/conv_single.py``) inside the reference's envelope.  The Hopper
kernel for chains of 'same' convs is ``kernels/conv_stack.py``.  Both
kernels' tap tables derive from the same ``c0`` offsets
(:func:`hex_valid_tap_table`).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from ..utils.profiling import annotate

__all__ = [
    "pad2d",
    "hex_kernel_num",
    "scatter_hex_kernel",
    "hex_valid_tap_table",
    "hex_tap_table",
    "hex_adjoint_tap_table",
    "hex_conv2d",
    "hex_conv2d_adaptive_padding",
    "hex_conv2d_output_shape",
    "hex_pool2d",
    "hex_adaptive_pool2d",
    "hex_global_pool2d",
    "max_pooling",
    "min_pooling",
    "average_pooling",
]

_PAD_MODES = {
    "constant": "constant",
    "zeros": "constant",
    "reflect": "reflect",
    "replicate": "replicate",
    "circular": "circular",
}


def _input_device(x, kernel) -> torch.device:
    """A tensor ``x`` stays on its device; other input follows the kernel
    when it is a tensor, else goes to the card."""
    return next((t.device for t in (x, kernel) if isinstance(t, torch.Tensor)),
                torch.device("cuda"))


def _as_4d(x, device="cuda") -> torch.Tensor:
    """A tensor stays on its device; other input goes to ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=device)
    while x.ndim < 4:
        x = x[None]
    return x


def pad2d(x: torch.Tensor, padding, mode: str = "constant", value=0):
    """Symmetric spatial padding of (..., H, W).  ``padding`` may be an int
    or ``(left, right, top, bottom)`` (``torch.nn.functional.pad`` order)."""
    if isinstance(padding, int):
        l = r = t = b = padding
    else:
        l, r, t, b = padding
    if l == r == t == b == 0:
        return x
    tmode = _PAD_MODES[mode]
    if tmode == "constant":
        return tF.pad(x, (l, r, t, b), mode="constant", value=value)
    # the non-constant modes take (N, C, H, W): fold the leading dims
    lead = x.shape[:-2]
    y = tF.pad(x.reshape((-1, 1) + tuple(x.shape[-2:])), (l, r, t, b),
               mode=tmode)
    return y.reshape(lead + tuple(y.shape[-2:]))


def hex_kernel_num(radius: int) -> int:
    """Number of cells in a hex kernel of the given radius."""
    return 3 * radius * radius - 3 * radius + 1


def _hex_kernel_rows(radius: int):
    """Per-row layout of the flat hex kernel: (row, vdist, ncells, start)."""
    ks = 2 * radius - 1
    rows, start = [], 0
    for i in range(ks):
        t = abs(i - radius + 1)
        ln = ks - t
        rows.append((i, t, ln, start))
        start += ln
    return rows


def _phase_offsets(radius: int, s: int, d: int, parity: int):
    """Column offsets ``c0`` of each kernel row for the even and the odd
    output-row phase (``hygrid_tpu/nn/functional.py:261-262``)."""
    rows = _hex_kernel_rows(radius)
    c0e = [(1 + t * d - ((i * d + parity) % 2)) // 2 for (i, t, ln, st) in rows]
    c0o = [(s + 1 + t * d - ((s + i * d + parity) % 2)) // 2
           for (i, t, ln, st) in rows]
    return c0e, c0o


def hex_valid_tap_table(radius: int, dilation: int = 1,
                        parity: int = 0) -> np.ndarray:
    """Source offsets of a stride-1 'valid' hex conv whose first input row
    has parity ``parity``.

    Returns int32 ``(2, kn, 2)``: for output-row parity ``q`` (even rows
    are the even phase) and flat tap ``t``, output pixel ``(o, j)`` reads
    input pixel ``(o + T[q, t, 0], j + T[q, t, 1])`` = ``(o + i*d,
    j + c0_q[i] + d*k)`` for kernel row ``i``, cell ``k``, with ``c0e, c0o
    = _phase_offsets(radius, 1, d, parity)``.  The output has
    :func:`hex_conv2d_output_shape` rows and columns; reads past the last
    column are zero.
    """
    d = dilation
    c0e, c0o = _phase_offsets(radius, 1, d, parity % 2)
    table = np.zeros((2, hex_kernel_num(radius), 2), np.int32)
    for q, c0 in enumerate((c0e, c0o)):
        for (i, t, ln, start) in _hex_kernel_rows(radius):
            for k in range(ln):
                table[q, start + k] = (i * d, c0[i] + d * k)
    return table


def hex_tap_table(radius: int, dilation: int = 1) -> np.ndarray:
    """Source offsets of a stride-1 'same' hex conv on offset-0 storage.

    Returns int32 ``(2, kn, 2)``: for output-row parity ``q`` and flat tap
    ``t``, output pixel ``(o, j)`` with ``o % 2 == q`` reads input pixel
    ``(o + T[q, t, 0], j + T[q, t, 1])`` (zero outside the image).  The
    'same' padding ``p = d*(r-1)`` flips the conv-internal parity to
    ``p % 2`` (``hygrid_tpu/nn/functional.py:479``): it is the valid
    conv's table on the padded image, shifted back by ``p``.
    """
    p = dilation * (radius - 1)
    return hex_valid_tap_table(radius, dilation, p % 2) - np.int32(p)


def hex_adjoint_tap_table(radius: int, dilation: int = 1) -> np.ndarray:
    """Tap table of the adjoint of the 'same' conv of :func:`hex_tap_table`.

    Forward output row ``o`` (parity ``q``) reads input row ``o + dr_t``
    with ``dr_t = T[q, t, 0]`` the same for both parities.  So input pixel
    ``(i, j)`` receives tap ``t`` from output row ``o = i - dr_t``, whose
    parity is ``(i % 2) ^ (dr_t & 1)``, at column ``j - dc`` with ``dc``
    read at that parity.  Returns int32 ``(2, kn, 2)``: for input-row
    parity ``p``, ``dL/dx(i, j) = sum_t W_t^T g(i + A[p, t, 0],
    j + A[p, t, 1])`` (zero outside the image), ``W_t`` the ``(Cout, Cin)``
    weights of tap ``t``.
    """
    fwd = hex_tap_table(radius, dilation)
    table = np.empty_like(fwd)
    for p in (0, 1):
        for t in range(fwd.shape[1]):
            dr = int(fwd[0, t, 0])
            table[p, t] = (-dr, -fwd[p ^ (dr & 1), t, 1])
    return table


def scatter_hex_kernel(kernel: torch.Tensor, radius: int, dilation: int = 1):
    """Scatter flat hex weights (O, I, kernelnum) into the sparse rect kernel
    (O, I, k_h, k_w) used over type-1 images."""
    d = dilation
    ks = 2 * radius - 1
    k_h = (ks - 1) * d + 1
    k_w = 2 * d * (ks - 1) + 1
    out = kernel.new_zeros(tuple(kernel.shape[:2]) + (k_h, k_w))
    for (i, t, ln, start) in _hex_kernel_rows(radius):
        out[:, :, i * d, t * d: t * d + (ln - 1) * 2 * d + 1: 2 * d] = \
            kernel[:, :, start:start + ln]
    return out


def _type1_expand(x: torch.Tensor, parity: int) -> torch.Tensor:
    """heximage -> type-1 on (B, C, H, W)."""
    b, c, h, w = x.shape
    doubled = torch.repeat_interleave(x, 2, dim=3)
    padded = tF.pad(doubled, (1, 1))
    q = (torch.arange(h, device=x.device) + parity) % 2
    col = torch.arange(2 * w + 1, device=x.device)[None, :] + (q[:, None] ^ 1)
    return torch.gather(padded, 3, col[None, None].expand(b, c, h, 2 * w + 1))


def _conv(x, w, stride, groups):
    return tF.conv2d(x, w, stride=stride, groups=groups)


def hex_conv2d_output_shape(h: int, w: int, radius: int, stride: int = 1,
                            padding: int = 0, dilation: int = 1
                            ) -> Tuple[int, int]:
    """Output (H', W') of hex_conv2d for an (h, w) input, following the
    reference's bookkeeping over the type-1 image."""
    h, w = h + 2 * padding, w + 2 * padding
    s, d = stride, dilation
    ks = 2 * radius - 1
    k_h = (ks - 1) * d + 1
    k_w = 2 * d * (ks - 1) + 1
    wt = 2 * w + 1
    wo = (wt - 1 - s - k_w) // (2 * s) + 1 if wt - 1 - s >= k_w else 0
    ho_e = (h - k_h) // (2 * s) + 1 if h >= k_h else 0
    ho_o = (h - s - k_h) // (2 * s) + 1 if h - s >= k_h else 0
    return ho_e + ho_o, wo


def _hex_conv2d_type1(x, weight, bias, parity, s, groups, k_h, k_w):
    t1 = _type1_expand(x, parity)
    even_in = t1[:, :, :, 1:-s]
    odd_in = t1[:, :, s:, s + 1:]
    evenconv = oddconv = None
    if even_in.shape[2] >= k_h and even_in.shape[3] >= k_w:
        evenconv = _conv(even_in, weight, (2 * s, 2 * s), groups)
    if odd_in.shape[2] >= k_h and odd_in.shape[3] >= k_w:
        oddconv = _conv(odd_in, weight, (2 * s, 2 * s), groups)
    return _merge_phases(evenconv, oddconv, bias)


def _merge_phases(evenconv, oddconv, bias):
    if evenconv is not None and oddconv is not None:
        wo = min(evenconv.shape[3], oddconv.shape[3])
        evenconv, oddconv = evenconv[..., :wo], oddconv[..., :wo]
        b, c = evenconv.shape[:2]
        he, ho = evenconv.shape[2], oddconv.shape[2]
        out = evenconv.new_zeros((b, c, he + ho, wo))
        out[:, :, ::2] = evenconv[:, :, :(he + ho + 1) // 2]
        out[:, :, 1::2] = oddconv[:, :, :(he + ho) // 2]
    elif evenconv is not None:
        out = evenconv
    elif oddconv is not None:
        out = oddconv
    else:
        raise ValueError(
            "input too small for this hex kernel "
            "(the reference crashes here too, HexFrames.py:163)")
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def _direct_phase_kernel(kernel, radius, d, c0):
    """Dense masked kernel for one row-parity phase of the direct path.
    Taps of kernel row i land at columns ``c0[i] - base + d*k``."""
    rows = _hex_kernel_rows(radius)
    base = min(c0)
    k_h = (2 * radius - 2) * d + 1
    k_w = max(c0[i] - base + d * (ln - 1) for (i, t, ln, st) in rows) + 1
    out = kernel.new_zeros(tuple(kernel.shape[:2]) + (k_h, k_w))
    for (i, t, ln, start) in rows:
        c = c0[i] - base
        out[:, :, i * d, c: c + (ln - 1) * d + 1: d] = \
            kernel[:, :, start:start + ln]
    return out, base, k_w


def _hex_conv2d_direct(x, kernel, bias, parity, radius, s, d, groups):
    """Two masked convs on the original brick-wall storage: a tap of the
    type-1 kernel at (row i*d, col t*d + 2dk) touches hex pixel
    ``(2s*ho + i*d, s*wo + d*k + c0(i))``, so the window stride over the
    un-expanded image is (2s, s)."""
    b, c, h, w = x.shape
    ks = 2 * radius - 1
    k_h = (ks - 1) * d + 1
    k_w_t1 = 2 * d * (ks - 1) + 1
    wt = 2 * w + 1

    c0e, c0o = _phase_offsets(radius, s, d, parity)

    exists_e = h >= k_h and wt - 1 - s >= k_w_t1
    exists_o = h - s >= k_h and wt - s - 1 >= k_w_t1
    wo = (wt - 1 - s - k_w_t1) // (2 * s) + 1

    evenconv = oddconv = None
    if exists_e or exists_o:
        ke, base_e, kwe = _direct_phase_kernel(kernel, radius, d, c0e)
        ko, base_o, kwo = _direct_phase_kernel(kernel, radius, d, c0o)
        need = max(base_e + kwe + s * (wo - 1), base_o + kwo + s * (wo - 1))
        if need > w:
            x = tF.pad(x, (0, need - w))
        if exists_e:
            ho_e = (h - k_h) // (2 * s) + 1
            evenconv = _conv(x[:, :, :, base_e:], ke, (2 * s, s), groups)
            evenconv = evenconv[:, :, :ho_e, :wo]
        if exists_o:
            ho_o = (h - s - k_h) // (2 * s) + 1
            oddconv = _conv(x[:, :, s:, base_o:], ko, (2 * s, s), groups)
            oddconv = oddconv[:, :, :ho_o, :wo]
    return _merge_phases(evenconv, oddconv, bias)


def hex_conv2d(x, kernel, bias=None, *, even_odd_offset: int = 0,
               radius: int, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1,
               padding_mode: str = "constant", padding_value=0,
               impl: str = "direct"):
    """Hexagonal convolution over brick-wall storage.

    Args:
        x: (B, C, H, W) (or fewer dims, auto-expanded).
        kernel: flat hex weights (O, C // groups, kernelnum) with
           ``kernelnum = 3r^2 - 3r + 1``; rows ordered top-to-bottom,
           cells left-to-right.  The reference (O, I, 1, kernelnum) layout
           is accepted too.
        even_odd_offset: parity of the FIRST input row; flips with padding.
        impl: ``"direct"`` (default) or ``"type1"`` (reference-mirroring)
           run plain PyTorch.  ``"pallas"`` runs the single-op conv kernel
           (:func:`hygrid_tpu_torch.kernels.conv_single.hex_conv_single`)
           inside the reference's envelope (stride 1, groups 1,
           ``128 % C == 0``, ``Cout * 128 / C <= 512``, padded height at
           least the kernel's plus 2) and ``"direct"`` outside it, where
           ``hygrid_tpu`` runs its XLA packed conv.  ``"auto"``, ``"mxu"``
           and ``"packed"`` are XLA formulations of the same function in
           ``hygrid_tpu``; here they run ``"direct"`` (cuDNN on the card).
           On an H100 ``"pallas"`` is slower than ``"direct"`` at
           HexCNN-small's shapes (about 1.2x in float32, 2x in bfloat16)
           and faster at odd parity, dilation 2 and radius 3 on narrower
           inputs; ``chip_smoke.py`` phase 14 times both.

    A tensor ``x`` stays on its device; other input goes to the kernel's
    device when the kernel is a tensor, else to the card.

    Returns (B, O, H', W') with output offset 0.  The conv computes in the
    kernel's dtype; a bias is added after it in the promoted dtype (a
    float32 bias on a bfloat16 conv gives float32, as JAX promotes in
    ``hygrid_tpu``), except on the ``"pallas"`` kernel route, which rounds
    the bias to the conv's dtype as the reference's
    ``packed_hex_conv_pallas`` does (``conv_pallas.py:205-206``).
    """
    device = _input_device(x, kernel)
    x = _as_4d(torch.as_tensor(x, device=device))
    kernel = torch.as_tensor(kernel, device=device)
    if kernel.ndim == 4:
        kernel = kernel[:, :, 0, :]
    x = x.to(kernel.dtype)
    if bias is not None:
        from_host = not isinstance(bias, torch.Tensor)
        bias = torch.as_tensor(bias, device=device)
        if from_host and bias.dtype == torch.float64:
            bias = bias.float()   # numpy or list input: JAX's float32
    x = pad2d(x, padding, padding_mode, padding_value)
    parity = (even_odd_offset + padding) % 2
    s, d = stride, dilation
    if impl == "pallas":
        from ..kernels import conv_single
        if conv_single.takes_single_route(x.shape[1], kernel.shape[0], s,
                                          groups, x.shape[2], radius, d):
            # padding already applied above; parity already folded
            return conv_single.hex_conv_single(
                x, kernel, bias, even_odd_offset=parity, radius=radius,
                padding=0, dilation=d)
        impl = "direct"
    if impl in ("auto", "mxu", "packed"):
        impl = "direct"
    if impl == "type1":
        ks = 2 * radius - 1
        k_h = (ks - 1) * d + 1
        k_w = 2 * d * (ks - 1) + 1
        weight = scatter_hex_kernel(kernel, radius, d)
        return _hex_conv2d_type1(x, weight, bias, parity, s, groups, k_h, k_w)
    if impl == "direct":
        return _hex_conv2d_direct(x, kernel, bias, parity, radius, s, d, groups)
    raise ValueError(f"unknown impl {impl!r}")


def hex_conv2d_adaptive_padding(x, kernel, bias=None, *,
                                even_odd_offset: int = 0, radius: int,
                                stride: int = 1, dilation: int = 1,
                                groups: int = 1, impl: str = "direct"):
    """TF-"same"-style hex conv (``hygrid_tpu/nn/functional.py:530-554``).

    Pads asymmetrically so ``output_h = ceil(h / stride)``; the reference's
    width rule uses ``output_w``, not ``output_w - 1`` (kept), and the
    row parity handed to the conv ignores the rows added on top (kept).
    """
    x = _as_4d(torch.as_tensor(x, device=_input_device(x, kernel)))
    h, w = x.shape[-2:]
    ks = 2 * radius - 1
    out_h = math.ceil(h / stride)
    out_w = math.ceil(w / stride)
    pad_h = max((out_h - 1) * stride + (ks - 1) * dilation + 1 - h, 0)
    pad_w = max(out_w * stride + (ks - 1) * dilation + 1 - w, 0)
    if pad_h > 0 or pad_w > 0:
        x = pad2d(x, (pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
    return hex_conv2d(x, kernel, bias, even_odd_offset=even_odd_offset,
                      radius=radius, stride=stride, padding=0,
                      dilation=dilation, groups=groups, impl=impl)


# --------------------- cell statistical properties ---------------------
# NaN-aware reductions (HexFrames.py:461-479)

def max_pooling(x: torch.Tensor, axis=-1):
    return torch.amax(torch.where(torch.isnan(x), -torch.inf, x), dim=axis)


def min_pooling(x: torch.Tensor, axis=-1):
    return torch.amin(torch.where(torch.isnan(x), torch.inf, x), dim=axis)


def average_pooling(x: torch.Tensor, axis=-1):
    nan = torch.isnan(x)
    count = (~nan).sum(dim=axis)
    total = torch.where(nan, 0, x).sum(dim=axis)
    mean = total / torch.clamp(count, min=1)
    return torch.where(count == 0, torch.nan, mean)


_REDUCTIONS = {"max": max_pooling, "min": min_pooling, "average": average_pooling}


def _reduction(method: str):
    if method == "centroid":
        raise NotImplementedError(
            "'centroid' pooling is declared but undefined in the reference "
            "(HexFrames.py:360,408 reference a non-existent centroid_pooling)")
    return _REDUCTIONS[method]


@annotate("hygrid.pool")
def hex_pool2d(x, method: str, kernel_size=2, stride=None, padding: int = 0,
               even_odd_offset: int = 0, padding_mode: str = "constant",
               padding_value=0, ceil_mode: bool = False,
               count_include_pad: bool = True, data_format: str = "NCHW",
               device="cuda"):
    """Strided pooling on the brick lattice, incl. the reference's ceil-mode
    bookkeeping (whose ph/pw pads land on width/height respectively —
    replicated).  Window ``(gi, gj)`` covers rows ``sh*gi + [0, kh)`` and
    cols ``(gi % 2)*(sw//2) + sw*gj + [0, kw)``.  ``data_format="NHWC"``
    pools (B, H, W, C) tensors with the same window math.  A tensor pools
    on its own device; other input is moved to ``device`` first.

    An NHWC max-pool of a CUDA float32 or bfloat16 tensor over windows of
    at most 2 x 2 cells that do not overlap, without padding or ceil mode
    (the models' pools), runs the hand-written kernel
    (:func:`hygrid_tpu_torch.kernels.pool.hex_max_pool`), whose values and
    gradient are this plain path's bit for bit."""
    x = _as_4d(x, device)
    _reduction(method)  # validate method early (clear centroid/KeyError)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    nhwc = data_format == "NHWC"
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    kh, kw = kernel_size
    if stride is None:
        stride = kernel_size
    if isinstance(stride, int):
        stride = (stride, stride)
    sh, sw = stride

    if nhwc:  # pad in an NCHW view; the window gather below reads NHWC
        x = x.permute(0, 3, 1, 2)
    x = pad2d(x, padding, padding_mode, padding_value)
    h, w = x.shape[2], x.shape[3]
    hn = h // sh
    wn = (w - sw // 2 - sw) // sw + 1
    if ceil_mode:
        ph = (kh - h + hn * sh) % kh
        pw_ = (kw - w + (wn * sw + sw // 2)) % kw
        fill = 0.0 if count_include_pad else float("nan")
        # reference quirk replicated: pw pads height, ph pads width
        x = tF.pad(x, (0, ph, 0, pw_), value=fill)
        h, w = x.shape[2], x.shape[3]
    hn, wn = _pool_windows(h, w, kh, sh, sw)

    half = sw // 2
    max_i = sh * (hn - 1) + kh - 1
    max_j = (half if hn > 1 else 0) + sw * (wn - 1) + kw - 1
    if max_i >= h or max_j >= w:
        raise ValueError(
            f"pooling window exceeds input: kernel {kernel_size}, stride "
            f"{stride} on ({h}, {w}) (the reference indexes out of bounds "
            "here as well, HexFrames.py:330-331)")
    if nhwc and method == "max" and x.is_cuda and padding == 0 \
            and not ceil_mode:
        from ..kernels import pool
        y = x.permute(0, 2, 3, 1)
        if pool.takes(y, kh, kw, sh, sw):
            return pool.hex_max_pool(y, (kh, kw), (sh, sw))
    return _window_reduce(x, method, hn, wn, kh, kw, sh, sw, half, nhwc)


def _pool_windows(h: int, w: int, kh: int, sh: int, sw: int) -> tuple:
    """``(hn, wn)``: the brick-lattice windows of rows ``kh`` at stride
    ``(sh, sw)`` in an ``(h, w)`` input (:func:`hex_pool2d` after its
    padding)."""
    return (h - kh) // sh + 1, (w - sw // 2) // sw


def _window_index(hn, wn, kh, kw, sh, sw, half, device):
    """``(rows (hn, 1, kh, 1), cols (hn, wn, 1, kw))``: the cells of each
    brick-lattice window, broadcasting to ``(hn, wn, kh, kw)``."""
    gi = torch.arange(hn, device=device)
    gj = torch.arange(wn, device=device)
    rows = sh * gi[:, None] + torch.arange(kh, device=device)   # (hn, kh)
    cols = ((gi % 2) * half)[:, None, None] + sw * gj[None, :, None] \
        + torch.arange(kw, device=device)                        # (hn, wn, kw)
    return rows[:, None, :, None], cols[:, :, None, :]


def _window_reduce(x, method, hn, wn, kh, kw, sh, sw, half, nhwc=False):
    """Reduce brick-lattice windows of NCHW ``x``: window ``(gi, gj)``
    covers rows ``sh*gi + [0, kh)`` and cols ``(gi % 2)*half + sw*gj +
    [0, kw)``, reduced in kh-major, kw-minor order.  ``nhwc`` returns
    ``(B, hn, wn, C)`` instead of ``(B, C, hn, wn)``.

    Max and min over windows that do not overlap (``kh <= sh``, ``kw <=
    sw``: the models' pools) reduce the rows first, then the columns, as
    ``hygrid_tpu``'s ``_hex_window_reduce`` does: the same values, and a
    tie's gradient split as ``jax.grad`` splits it (evenly at each stage,
    so three tied cells of a 2x2 window get 1/4, 1/4 and 1/2)."""
    ri, ci = _window_index(hn, wn, kh, kw, sh, sw, half, x.device)
    reduce = _REDUCTIONS[method]
    two_stage = method in ("max", "min") and kh <= sh and kw <= sw
    if nhwc:
        win = x.permute(0, 2, 3, 1)[:, ri, ci, :]        # (B,hn,wn,kh,kw,C)
        if two_stage:
            return reduce(reduce(win, axis=3), axis=3)
        return reduce(win.flatten(3, 4), axis=3)
    win = x[:, :, ri, ci]                                  # (B,C,hn,wn,kh,kw)
    if two_stage:
        return reduce(reduce(win, axis=-2), axis=-1)
    return reduce(win.flatten(-2), axis=-1)


def hex_adaptive_pool2d(x, outsize, method: str, device="cuda"):
    """Adaptive output-size pooling (``hygrid_tpu/nn/functional.py:837``,
    ``HexFrames.py:344-401``): ``outsize`` is an int or ``(h, w)``; window
    indices past the image are clipped to it, which equals edge
    replication by the largest overrun.  A tensor pools on its own
    device; other input is moved to ``device`` first."""
    x = _as_4d(x, device)
    _reduction(method)  # validate method early
    if isinstance(outsize, int):
        outsize = (outsize, outsize)
    hn, wn = outsize
    h, w = x.shape[-2:]
    grid_h = int(h / hn)
    grid_w = int(w / (wn + 0.5)) if grid_h > 1 else int(w / wn)
    half = grid_w // 2
    max_i = grid_h * (hn - 1) + grid_h - 1
    max_j = (half if hn > 1 else 0) + grid_w * (wn - 1) + grid_w - 1
    pad_b, pad_r = max(0, max_i - (h - 1)), max(0, max_j - (w - 1))
    if pad_b or pad_r:
        x = pad2d(x, (0, pad_r, 0, pad_b), "replicate")
    return _window_reduce(x, method, hn, wn, grid_h, grid_w, grid_h, grid_w,
                          half)


@annotate("hygrid.pool")
def hex_global_pool2d(x, method: str, data_format: str = "NCHW",
                      device="cuda"):
    """Global pooling over the flattened spatial dims -> (B, C).  A tensor
    pools on its own device; other input is moved to ``device`` first."""
    x = _as_4d(x, device)
    if data_format == "NHWC":
        b, c = x.shape[0], x.shape[-1]
        return _reduction(method)(x.reshape(b, -1, c), axis=1)
    b, c = x.shape[:2]
    return _reduction(method)(x.reshape(b, c, -1))
