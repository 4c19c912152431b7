"""Kernel B: the hex conv layer (``csrc/hex_conv_layer.cu``) and the
'same' conv stack built from it.

Port of the stack part of ``hygrid_tpu/kernels/conv_pallas.py``:
:func:`hex_conv_stack` takes ``hex_conv_stack_pallas``'s arguments and runs
one :func:`hex_conv_layer` per layer on NHWC activations.  Each layer is a
stride-1 'same' hex conv (padding ``d*(r-1)``), then bias, an optional norm
and an optional ReLU, as ``_stack_layer_kernel`` computes it:

* ``("gn", G, gamma, beta)`` — per-sample GroupNorm over G channel groups,
  statistics from the float32 pre-activation (``E[x^2] - mean^2`` clamped
  at 0, eps 1e-5);
* ``("affine", scale, shift)`` — per-channel ``x * scale + shift``.

The TPU's lane packing, plane margins, in-place aliasing, banding and
whole-stack fusion are not ported: ``fused``, ``band_rows``, ``packed_io``
and ``extra_input`` raise ``NotImplementedError``.

The plain version of a layer is :func:`hex_conv_layer_plain`
(``hex_conv2d(impl="direct")`` + :func:`_group_norm_nchw`, computed in
float32); chained, it is the twin of ``conv_pallas._stack_xla``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..nn import functional as F
from . import _build

__all__ = ["hex_conv_layer", "hex_conv_layer_plain", "hex_conv_stack"]

LAUNCHES = 0
"""Number of layers run by the kernel (one GN layer is four CUDA launches
and counts once)."""

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EPS = 1e-5
_GN_BLOCKS = 2048   # target (sample, pixel-chunk) blocks of the GN stats pass


@functools.lru_cache(maxsize=None)
def _taps(radius: int, dilation: int) -> np.ndarray:
    table = np.ascontiguousarray(F.hex_tap_table(radius, dilation))
    table.setflags(write=False)
    return table


def _group_norm_nchw(v: torch.Tensor, groups: int, gamma, beta,
                     eps: float = _EPS) -> torch.Tensor:
    """Plain per-sample GroupNorm on (B, C, H, W), statistics in float32
    (twin of ``conv_pallas._group_norm_nchw``)."""
    b, c, h, w = v.shape
    g = v.reshape(b, groups, (c // groups) * h * w).float()
    mean = g.mean(dim=-1)
    var = g.var(dim=-1, unbiased=False)
    mean = mean.repeat_interleave(c // groups, dim=1)[:, :, None, None]
    inv = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)[
        :, :, None, None]
    out = (v.float() - mean) * inv
    out = out * gamma.float()[None, :, None, None] \
        + beta.float()[None, :, None, None]
    return out.to(v.dtype)


def hex_conv_layer_plain(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                         radius: int, dilation: int = 1, norm=None,
                         relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`hex_conv_layer`, on any device.

    Computes in float32 (the kernel's accumulation type) and returns the
    input's dtype.  On CUDA, ``torch.nn.functional.conv2d`` runs in TF32
    unless ``torch.backends.cudnn.allow_tf32`` is False.
    """
    h = F.hex_conv2d(x.permute(0, 3, 1, 2).float(), kernel.float(),
                     None if bias is None else bias.float(),
                     even_odd_offset=0, radius=radius,
                     padding=dilation * (radius - 1), dilation=dilation,
                     impl="direct")
    if norm is not None:
        if norm[0] == "gn":
            _, groups, gamma, beta = norm
            h = _group_norm_nchw(h, groups, gamma, beta)
        else:
            _, scale, shift = norm
            h = h * scale.float()[None, :, None, None] \
                + shift.float()[None, :, None, None]
    if relu:
        h = torch.relu(h)
    return h.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check_param(t, name, n, device):
    if t is None:
        return None
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"hex_conv_layer: {name} must be ({n},) on {device}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def hex_conv_layer(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                   radius: int, dilation: int = 1, norm=None,
                   relu: bool = False) -> torch.Tensor:
    """One stride-1 'same' hex conv layer on NHWC ``x`` ``(B, H, W, Cin)``
    with flat hex weights ``kernel`` ``(Cout, Cin, kn)``, then ``bias``, an
    optional ``norm`` (``("gn", G, gamma, beta)`` or ``("affine", scale,
    shift)``) and an optional ReLU.  Returns ``(B, H, W, Cout)`` in x's
    dtype.

    A CPU tensor runs :func:`hex_conv_layer_plain`.  A CUDA tensor (float32
    or bfloat16, contiguous) launches the kernel; anything else raises.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return hex_conv_layer_plain(x, kernel, bias, radius=radius,
                                    dilation=dilation, norm=norm, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"hex_conv_layer: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"hex_conv_layer: the kernel takes float32 or "
                        f"bfloat16 activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("hex_conv_layer: x must be a contiguous (B, H, W, C) "
                         "tensor")
    b, h, w, cin = x.shape
    kn = F.hex_kernel_num(radius)
    cout = kernel.shape[0]
    if tuple(kernel.shape) != (cout, cin, kn) or kernel.device != x.device:
        raise ValueError(f"hex_conv_layer: kernel must be ({cout}, {cin}, "
                         f"{kn}) on {x.device}, got {tuple(kernel.shape)} "
                         f"on {kernel.device}")
    if h > 65535 or b * math.ceil(cout / 32) > 65535:
        raise ValueError(f"hex_conv_layer: grid too large for H={h}, B={b}, "
                         f"Cout={cout}")
    wt = kernel.float().permute(2, 1, 0).contiguous()       # (kn, Cin, Cout)
    bias = _check_param(bias, "bias", cout, x.device)
    scale = shift = gamma = beta = y = partial = stats = None
    groups = n_chunks = 0
    if norm is not None and norm[0] == "gn":
        _, groups, gamma, beta = norm
        if cout % groups or cout > 1024:
            raise ValueError(f"hex_conv_layer: GroupNorm needs groups | Cout "
                             f"<= 1024, got {groups} groups, Cout={cout}")
        gamma = _check_param(gamma, "gamma", cout, x.device)
        beta = _check_param(beta, "beta", cout, x.device)
        n_chunks = max(1, min(h * w, -(-_GN_BLOCKS // b)))
        y = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
        partial = torch.empty((b, n_chunks, groups, 2), dtype=torch.float32,
                              device=x.device)
        stats = torch.empty((b, groups, 2), dtype=torch.float32,
                            device=x.device)
    elif norm is not None:
        _, scale, shift = norm
        scale = _check_param(scale, "scale", cout, x.device)
        shift = _check_param(shift, "shift", cout, x.device)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    taps = _taps(radius, dilation)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hg_hex_conv_layer(
            x.data_ptr(), wt.data_ptr(), ptr(bias), ptr(scale), ptr(shift),
            ptr(gamma), ptr(beta), groups, _EPS, ptr(y), ptr(partial),
            ptr(stats), n_chunks, out.data_ptr(), _DTYPES[x.dtype], b, h, w,
            cin, cout, kn, taps.ctypes.data, int(relu), stream)
    _build.check(status, "hex_conv_layer")
    LAUNCHES += 1
    return out


def _split_norms(norms, kernels):
    """Validate the per-layer ``norms`` list (``conv_pallas._split_norms``)
    and return one normalised entry per layer."""
    if norms is None:
        return [None] * len(kernels)
    if len(norms) != len(kernels):
        raise ValueError(f"norms has {len(norms)} entries for "
                         f"{len(kernels)} layers")
    out = []
    for i, (n, k) in enumerate(zip(norms, kernels)):
        if n is None:
            out.append(None)
        elif n[0] == "gn":
            _, g, gamma, beta = n
            if int(k.shape[0]) % int(g):
                raise ValueError(f"layer {i}: {g} groups do not divide "
                                 f"{int(k.shape[0])} channels")
            out.append(("gn", int(g), gamma, beta))
        elif n[0] == "affine":
            _, scale, shift = n
            out.append(("affine", scale, shift))
        else:
            raise ValueError(f"unknown norm spec {n!r}")
    return out


def hex_conv_stack(x: torch.Tensor, kernels, biases=None, *, radius: int,
                   even_odd_offset: int = 0, dilation: int = 1,
                   activation="relu", final_activation: bool = True,
                   norms=None, data_format: str = "NCHW",
                   fused: bool = False, band_rows=None,
                   packed_io: bool = False, extra_input=None,
                   plain: bool = False) -> torch.Tensor:
    """A chain of 'same' hex convolutions, one :func:`hex_conv_layer` each.

    Equal to chaining ``act(norm(hex_conv2d(x, k, b, padding=d*(r-1))))``;
    the trailing activation is skipped when ``final_activation`` is False.
    ``norms`` has one entry per layer: None, ``("gn", G, gamma, beta)`` or
    ``("affine", scale, shift)``.  ``data_format`` is "NCHW" or "NHWC" for
    both input and output (layers run NHWC).  ``plain=True`` runs
    :func:`hex_conv_layer_plain` on any device (the reference a kernel run
    is compared with).
    """
    for name, val in (("fused", fused), ("band_rows", band_rows is not None),
                      ("packed_io", packed_io),
                      ("extra_input", extra_input is not None)):
        if val:
            raise NotImplementedError(
                f"hex_conv_stack: {name} is not ported yet (ROADMAP queue 2: "
                "the TPU's fused, banded, packed and split stack kernels)")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    if even_odd_offset != 0:
        raise ValueError("the stack assumes offset-0 input (the output "
                         "convention of every op in this framework)")
    if activation not in ("relu", None, "none"):
        raise ValueError("supported fused activations: 'relu' or None")
    while x.ndim < 4:
        x = x[None]
    kernels = list(kernels)
    biases = [None] * len(kernels) if biases is None else list(biases)
    norms = _split_norms(norms, kernels)
    layer = hex_conv_layer_plain if plain else hex_conv_layer
    h = x.permute(0, 2, 3, 1) if data_format == "NCHW" else x
    h = h.contiguous()
    n = len(kernels)
    for i, (k, bs, nm) in enumerate(zip(kernels, biases, norms)):
        relu = activation == "relu" and (final_activation or i < n - 1)
        h = layer(h, k, bs, radius=radius, dilation=dilation, norm=nm,
                  relu=relu)
    return h.permute(0, 3, 1, 2) if data_format == "NCHW" else h
