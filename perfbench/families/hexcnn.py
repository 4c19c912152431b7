"""The HexCNN family: how the benchmark builds it from a configuration's
sizes through the port's public constructor, and the layer shapes that
its FLOP counts and rooflines are computed from."""
from __future__ import annotations

TASK = "classify"
REFERENCE = "hexcnn"


def build(cfg: dict, dtype, device, generator):
    from hygrid_tpu_torch.models import HexCNN
    return HexCNN(num_classes=cfg["num_classes"],
                  channels=tuple(cfg["channels"]), depth=cfg["depth"],
                  radius=cfg["radius"], norm=cfg["norm"],
                  in_channels=cfg["in_channels"], dtype=dtype,
                  device=device, generator=generator)


def pooled(h: int, w: int):
    """The size after a stride-2 hex max-pool."""
    return (h - 2) // 2 + 1, (w - 1) // 2


def layers(cfg: dict, batch: int, hw) -> list:
    """Every layer with products, in order: ``op`` "conv" (a 'same' hex
    conv with GN and ReLU) or "linear"; ``n`` the output cells (rows for
    "linear"), ``cin``, ``cout``, ``taps``; ``dx`` whether the backward
    computes the input's gradient."""
    taps = 3 * cfg["radius"] ** 2 - 3 * cfg["radius"] + 1
    (h, w), cin, out = hw, cfg["in_channels"], []
    channels = cfg["channels"]
    for s, width in enumerate(channels):
        for _ in range(cfg["depth"]):
            out.append(dict(op="conv", n=batch * h * w, cin=cin, cout=width,
                            taps=taps, dx=bool(out)))
            cin = width
        if s != len(channels) - 1:
            h, w = pooled(h, w)
    out.append(dict(op="linear", n=batch, cin=cin, cout=cfg["num_classes"],
                    taps=1, dx=True))
    return out
