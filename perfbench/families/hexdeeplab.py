"""The HexDeepLabV3 family: how the benchmark builds it from a
configuration's sizes through the port's public constructor, and the layer
shapes that its FLOP counts and rooflines are computed from."""
from __future__ import annotations

TASK = "segment"
REFERENCE = "hexdeeplab"


def build(cfg: dict, dtype, device, generator):
    from hygrid_tpu_torch.models import HexDeepLabV3
    return HexDeepLabV3(num_classes=cfg["num_classes"],
                        blocks=tuple(cfg["blocks"]),
                        widths=tuple(cfg["widths"]),
                        expansion=cfg["expansion"],
                        stem_radius=cfg["stem_radius"],
                        aspp_rates=tuple(cfg["aspp_rates"]),
                        aspp_width=cfg["aspp_width"], groups=cfg["groups"],
                        in_channels=cfg["in_channels"], dtype=dtype,
                        device=device, generator=generator)


def taps(radius: int) -> int:
    return 3 * radius ** 2 - 3 * radius + 1


def strided(h: int, w: int):
    """The size after a stride-2 hex conv whose padding is its radius less
    one: the cells whose centres ``(2 o, 2 j + o % 2)`` lie in the image."""
    return (h - 1) // 2 + 1, (w - 2) // 2 + 1


def pooled3(h: int, w: int):
    """The size after the stem's 3 x 3 stride-2 max-pool with one cell of
    padding."""
    return (h - 1) // 2 + 1, (w + 1) // 2


def layers(cfg: dict, batch: int, hw) -> list:
    """Every layer, in order, as it computes: ``op`` "conv" (a stride-1 hex
    conv with GN on kernel B's route, ReLU or not), "sconv" (a stride-2 hex
    conv with GN through cuDNN; ``n_in`` its input cells), "join" (a
    residual join ``relu(a + b)``: ``n`` cells of ``cout`` channels, no
    products), "linear" (the classifier, a row a cell) and "resize" (the
    logits' linear hex resample to the input lattice: ``n`` output cells of
    ``cout`` channels, ``taps`` source cells blended each, from ``src``);
    ``n`` the output cells, ``cin``, ``cout``, ``taps`` (the kernel's, every
    tap of a dilated kernel counted, as the kernel computes it); ``dx``
    whether the backward computes the input's gradient.  ASPP's
    image-pooling branch is a "conv" on one cell an image."""
    (h, w), out = hw, []
    b = batch
    widths, exp = cfg["widths"], cfg["expansion"]
    h2, w2 = strided(h, w)
    out.append(dict(op="sconv", n=b * h2 * w2, n_in=b * h * w,
                    cin=cfg["in_channels"], cout=widths[0],
                    taps=taps(cfg["stem_radius"]), dx=False))
    h, w = pooled3(h2, w2)
    cin = widths[0]
    for s, (blocks, width) in enumerate(zip(cfg["blocks"], widths)):
        for i in range(blocks):
            stride = 2 if i == 0 and s in (1, 2) else 1
            n_in = b * h * w
            if stride == 2:
                h, w = strided(h, w)
            n = b * h * w
            out.append(dict(op="conv", n=n_in, cin=cin, cout=width, taps=1,
                            dx=True))
            if stride == 2:
                out.append(dict(op="sconv", n=n, n_in=n_in, cin=width,
                                cout=width, taps=7, dx=True))
            else:
                out.append(dict(op="conv", n=n, cin=width, cout=width,
                                taps=7, dx=True))
            out.append(dict(op="conv", n=n, cin=width, cout=exp * width,
                            taps=1, dx=True))
            if stride == 2:
                out.append(dict(op="sconv", n=n, n_in=n_in, cin=cin,
                                cout=exp * width, taps=1, dx=True))
            elif cin != exp * width:
                out.append(dict(op="conv", n=n, cin=cin, cout=exp * width,
                                taps=1, dx=True))
            cin = exp * width
            out.append(dict(op="join", n=n, cin=cin, cout=cin, taps=0,
                            dx=True))
    n, aw = b * h * w, cfg["aspp_width"]
    out.append(dict(op="conv", n=n, cin=cin, cout=aw, taps=1, dx=True))
    for _ in cfg["aspp_rates"]:
        out.append(dict(op="conv", n=n, cin=cin, cout=aw, taps=7, dx=True))
    out.append(dict(op="conv", n=b, cin=cin, cout=aw, taps=1, dx=True))
    out.append(dict(op="conv", n=n, cin=(2 + len(cfg["aspp_rates"])) * aw,
                    cout=aw, taps=1, dx=True))
    out.append(dict(op="linear", n=n, cin=aw, cout=cfg["num_classes"],
                    taps=1, dx=True))
    H, W = hw
    out.append(dict(op="resize", n=b * H * W, cin=1,
                    cout=cfg["num_classes"], taps=3, dx=False, src=[h, w]))
    return out
