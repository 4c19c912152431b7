"""The max-pools' backward (`hygrid_tpu_torch/kernels/pool.py`, the op
``hygrid::hex_max_pool_backward``) against its bound: each max-pool's
output gradient read and its input gradient written once at 3.35 TB/s, from
the layer shapes (a max-pool sits where the cells a conv layer sees shrink,
as `pool_roofline_pct.py` finds it; the global pool before a linear head is
not one).  The tie mask the backward also reads is left out, so the bound
counts the same work whatever implements it.  Over the device time of the
kernels launched under the port's ``hygrid.pool_backward`` spans (on the
autograd thread) in the traced window.  A serving run, or a trace without
the span (a port whose pools' backward runs as torch's autograd nodes),
reads nothing."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.pool_backward",)


def pool_backward_parts(layers, dtype: str):
    e = roofline.ESIZE[dtype]
    return [roofline.bound(e * a["cout"] * (b["n"] + a["n"]), 0.0, dtype)
            for a, b in zip(layers, layers[1:])
            if a["op"] in roofline.CONVS and b["op"] != "linear"
            and b["n"] < a["n"]]


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    return roofline_pct(run, pool_backward_parts(run.layers, run.dtype),
                        SPANS)
