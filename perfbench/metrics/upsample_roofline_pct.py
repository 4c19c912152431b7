"""HexUNet's transposed convs (`nn/experimental.py::hex_conv_transpose2d`:
the layout changes, cuDNN's sub-convolutions, the pads, stacks and phase
interleaves) against their bound: each "tconv" layer's input read, the
output cells it writes (its output shape, about 4 an input cell) and its
weights once at 3.35 TB/s, or its products at the dtype's peak
(``roofline.layer_flops``: each input cell meets every tap once), whichever
is longer; over the device time of the kernels launched under the port's
``hygrid.conv_transpose`` spans (the forward; the backward runs under
torch's autograd nodes) in the traced window.  None where the model has no
transposed conv or the trace no such span."""
from perfbench import roofline
from perfbench.families.hexcnn import pooled
from perfbench.readers import roofline_pct

SPANS = ("hygrid.conv_transpose",)


def tconv_out(h: int, w: int, radius: int, stride: int = 2):
    """(rows, columns) of the stride-``stride`` transposed conv's output on
    an ``(h, w)`` input: its two row phases interleaved, both as wide as
    the conv of the zero-stuffed canvas leaves them."""
    s, p = stride, radius - 1
    rows = s * h - s + 1 + 2 * p
    cols = 2 * s * w - s + 2 + (1 - s % 2) + 4 * p - 1 - s
    even = (rows - (2 * radius - 1)) // 2 + 1
    odd = (rows - s - (2 * radius - 1)) // 2 + 1
    return even + odd, (cols - (4 * radius - 3)) // 2 + 1


def tconv_parts(cfg, batch: int, layers, dtype: str):
    e = roofline.ESIZE[dtype]
    sizes, hw = [], tuple(cfg["hex"])
    while min(hw) > 1:
        hw = pooled(*hw)
        sizes.append(hw)
    parts = []
    for l in layers:
        if l["op"] != "tconv":
            continue
        h, w = next(s for s in sizes if batch * s[0] * s[1] == l["n"])
        ho, wo = tconv_out(h, w, cfg["radius"])
        nbytes = e * (l["n"] * l["cin"] + batch * ho * wo * l["cout"]
                      + l["cin"] * l["cout"] * l["taps"])
        parts.append(roofline.bound(nbytes, roofline.layer_flops(l), dtype))
    return parts


def read(run):
    return roofline_pct(run, tconv_parts(run.cell.cfg,
                                         run.cell.traffic["batch"],
                                         run.layers, run.dtype), SPANS)
