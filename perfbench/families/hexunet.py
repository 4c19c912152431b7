"""The HexUNet family: how the benchmark builds it from a configuration's
sizes through the port's public constructor, and the layer shapes that
its FLOP counts and rooflines are computed from."""
from __future__ import annotations

from .hexcnn import pooled

TASK = "segment"
REFERENCE = "hexunet"


def build(cfg: dict, dtype, device, generator):
    from hygrid_tpu_torch.models import HexUNet
    return HexUNet(num_classes=cfg["num_classes"],
                   widths=tuple(cfg["widths"]), radius=cfg["radius"],
                   depth=cfg["depth"], norm=cfg["norm"],
                   upsample=cfg["upsample"], dtype=dtype,
                   in_channels=cfg["in_channels"], device=device,
                   generator=generator)


def layers(cfg: dict, batch: int, hw) -> list:
    """As :func:`hexcnn.layers`; "split" is a decoder stage's first conv on
    ``[upsampled, skip]`` and "tconv" the stride-2 transposed conv, whose
    ``n`` counts its input cells (each cell meets every tap once)."""
    taps = 3 * cfg["radius"] ** 2 - 3 * cfg["radius"] + 1
    widths = cfg["widths"]
    (h, w), cin, out, sizes = hw, cfg["in_channels"], [], []
    for i, width in enumerate(widths):
        for _ in range(cfg["depth"]):
            out.append(dict(op="conv", n=batch * h * w, cin=cin, cout=width,
                            taps=taps, dx=bool(out)))
            cin = width
        if i != len(widths) - 1:
            sizes.append((h, w))
            h, w = pooled(h, w)
    for width in reversed(widths[:-1]):
        out.append(dict(op="tconv", n=batch * h * w, cin=cin, cout=width,
                        taps=taps, dx=True))
        h, w = sizes.pop()
        for d in range(cfg["depth"]):
            out.append(dict(op="split" if d == 0 else "conv",
                            n=batch * h * w, cin=2 * width if d == 0
                            else width, cout=width, taps=taps, dx=True))
        cin = width
    out.append(dict(op="linear", n=batch * h * w, cin=cin,
                    cout=cfg["num_classes"], taps=1, dx=True))
    return out
