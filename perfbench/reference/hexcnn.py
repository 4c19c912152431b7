"""Plain float32 HexCNN: hex conv stages (conv, GroupNorm, ReLU) with
stride-2 hex max-pools between them, a global average pool and a linear
head.  ``params`` holds the benchmark's weights under the model's public
parameter names (``stage{s}.kernel_{d}``, ``stage{s}.gn_scale_{d}``,
``stage{s}.gn_bias_{d}``, ``head.weight``, ``head.bias``)."""
from __future__ import annotations

import math

from . import hexlib as H


def forward(params: dict, x, cfg: dict, q=None):
    """Logits ``(B, num_classes)`` of hex images ``(B, C, h, w)``."""
    channels = cfg["channels"]
    for s, width in enumerate(channels):
        for d in range(cfg["depth"]):
            pre = f"stage{s}."
            x = H.hex_conv(x, params[f"{pre}kernel_{d}"], cfg["radius"], q)
            x = H.group_norm(x, math.gcd(cfg["groups"], width),
                             params[f"{pre}gn_scale_{d}"],
                             params[f"{pre}gn_bias_{d}"])
            x = H._store(q, x.relu())
        if s != len(channels) - 1:
            x = H.hex_maxpool2(x)
    x = H._store(q, x.mean((2, 3)))
    return H.linear(x, params["head.weight"], params["head.bias"], q)
