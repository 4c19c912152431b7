"""The card's peaks and the least time the work could take.

The peaks are NVIDIA's published H100 SXM figures (dense, at the 700 W
limit), as ``chip_smoke.py`` has them; :func:`bound` and
:func:`summed_bound` are its arithmetic.  The work is counted from the
layer shapes of a configuration (``perfbench/families``): each input,
weight and output byte once, and ``2 * cin * cout * taps`` operations an
output cell of a hex conv.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ESIZE = {"bfloat16": 2, "float32": 4}
CONVS = ("conv", "split")


def bound(nbytes: float, flops: float, dtype: str):
    """(seconds, "bytes" or "operations"): the larger of moving ``nbytes``
    once at the card's bandwidth and doing ``flops`` at ``dtype``'s peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def summed_bound(parts):
    """Sum of per-call bounds, named by the kind that bounds more of it."""
    total = sum(s for s, _ in parts)
    by_bytes = sum(s for s, by in parts if by == "bytes")
    return dict(bound_s=total,
                bound_by="bytes" if by_bytes >= total - by_bytes
                else "operations")


def layer_flops(layer: dict) -> float:
    """One pass of a layer's products: the forward, dx or dW alike."""
    return 2.0 * layer["n"] * layer["cin"] * layer["cout"] * layer["taps"]


def model_flops(layers, training: bool) -> float:
    """Operations of one call: the forward, and for a training step each
    layer's dW and (where the input needs it) dx as well."""
    total = 0.0
    for layer in layers:
        f = layer_flops(layer)
        total += f * (1 + (2 if layer["dx"] else 1) * training)
    return total


def conv_forward_parts(layers, dtype: str):
    """The bound of each hex conv layer's forward launch (GN layers: the
    input and weights read, the float32 pre-activation and the output
    written, the GN vectors read)."""
    e = ESIZE[dtype]
    parts = []
    for l in layers:
        if l["op"] not in CONVS:
            continue
        nbytes = (e * l["n"] * (l["cin"] + l["cout"]) + 4 * l["n"] * l["cout"]
                  + e * l["cout"] * l["cin"] * l["taps"] + 8 * l["cout"])
        parts.append(bound(nbytes, layer_flops(l), dtype))
    return parts


def conv_backward_parts(layers, dtype: str):
    """The bound of each hex conv layer's backward: the GN backward (the
    float32 pre-activation and the output's gradient read, the
    pre-activation's gradient written), dx where the input needs it and
    dW, each by the larger of its bytes and its operations."""
    e = ESIZE[dtype]
    parts = []
    for l in layers:
        if l["op"] not in CONVS:
            continue
        n, ci, co, w = l["n"], l["cin"], l["cout"], l["cout"] * l["cin"] * l["taps"]
        parts.append(bound(4 * n * co + 2 * e * n * co, 0.0, dtype))
        if l["dx"]:
            parts.append(bound(e * n * (co + ci) + e * w, layer_flops(l),
                               dtype))
        parts.append(bound(e * n * (ci + co) + 4 * w, layer_flops(l), dtype))
    return parts
