"""The pools (`nn/functional.py::hex_pool2d`, `hex_global_pool2d`: the
NaN-aware reductions, the window gathers, the layout changes) against their
bound: each pool's input read and output written once at 3.35 TB/s, from
the layer shapes (a pool sits where the cells a layer sees shrink; its input
is the stage's last conv output).  A stride-2 max-pool reads only its
windows, 2 x 2 disjoint cells an output cell; the global pool reads every
cell.  Over the device time of the kernels launched under the port's
``hygrid.pool`` spans (the forward; the pools' backward runs under torch's
autograd nodes) in the traced window; None where the trace holds no such
span."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.pool",)


def pool_parts(layers, dtype: str):
    e = roofline.ESIZE[dtype]
    parts = []
    for a, b in zip(layers, layers[1:]):
        if a["op"] in roofline.CONVS and b["n"] < a["n"]:
            read = a["n"] if b["op"] == "linear" else 4 * b["n"]
            parts.append(roofline.bound(e * a["cout"] * (read + b["n"]), 0.0,
                                        dtype))
    return parts


def read(run):
    return roofline_pct(run, pool_parts(run.layers, run.dtype), SPANS)
