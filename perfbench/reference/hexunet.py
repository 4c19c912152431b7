"""Plain float32 HexUNet: encoder stages (hex conv, GroupNorm, ReLU) and
stride-2 hex max-pools; a decoder stage upsamples by the stride-2
transposed hex conv, crops or pads to the skip's size, and convolves the
channel concatenation ``[upsampled, skip]``; a linear head gives per-cell
logits.  ``params`` holds the benchmark's weights under the model's public
parameter names (``enc{i}.*``, ``up{i}.kernel``, ``dec{i}.*``,
``head.*``)."""
from __future__ import annotations

import math

import torch

from . import hexlib as H


def _stage(params, pre, x, cfg, width, q):
    for d in range(cfg["depth"]):
        x = H.hex_conv(x, params[f"{pre}.kernel_{d}"], cfg["radius"], q)
        x = H.group_norm(x, math.gcd(cfg["groups"], width),
                         params[f"{pre}.gn_scale_{d}"],
                         params[f"{pre}.gn_bias_{d}"])
        x = H._store(q, x.relu())
    return x


def forward(params: dict, x, cfg: dict, q=None):
    """Per-cell logits ``(B, num_classes, h, w)`` of hex images ``(B, C, h,
    w)``."""
    widths = cfg["widths"]
    skips = []
    for i, width in enumerate(widths):
        x = _stage(params, f"enc{i}", x, cfg, width, q)
        if i != len(widths) - 1:
            skips.append(x)
            x = H.hex_maxpool2(x)
    for i, width in enumerate(reversed(widths[:-1])):
        x = H._store(q, H.hex_conv_transpose2(x, params[f"up{i}.kernel"],
                                              cfg["radius"], q))
        skip = skips.pop()
        x = H.crop_or_pad(x, skip.shape[-2:])
        x = _stage(params, f"dec{i}", torch.cat([x, skip], 1), cfg, width, q)
    logits = H.linear(x.permute(0, 2, 3, 1), params["head.weight"],
                      params["head.bias"], q)
    return logits.permute(0, 3, 1, 2)
