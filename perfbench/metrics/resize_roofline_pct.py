"""The logits' hex->hex resample (`ops/geometry.py::hexresize`: the
`csrc/plan_gather.cu` launch and its host code) against its bound: the
source cells the plan blends with a weight other than 0 read once (the plain
reference's own plan, `reference/hexdeeplab.py::hexresize_plan`) and the
output written once at 3.35 TB/s, for each "resize" layer; over the device
time of the kernels launched under the port's ``hygrid.hexresize`` spans in
the traced window.  None for a model without the resize, a serving run, or
a trace without the span."""
import numpy as np

from perfbench import roofline
from perfbench.readers import roofline_pct
from perfbench.reference.hexdeeplab import hexresize_plan

SPANS = ("hygrid.hexresize",)


def resize_parts(run):
    e, cfg = roofline.ESIZE[run.dtype], run.cell.cfg
    batch = run.cell.traffic["batch"]
    parts = []
    for l in run.layers:
        if l["op"] != "resize":
            continue
        idx, wts = hexresize_plan(*l["src"], *cfg["hex"])
        read = np.unique(idx[wts != 0]).size
        parts.append(roofline.bound(e * l["cout"] * (batch * read + l["n"]),
                                    0.0, run.dtype))
    return parts


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    return roofline_pct(run, resize_parts(run), SPANS)
