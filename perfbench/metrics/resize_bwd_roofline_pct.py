"""The logits' resample's backward (`kernels/resample.py::
plan_gather_vjp_plain`, the plan's transpose: a float32 scatter-add) against
its bound: the output's gradient read and the source's gradient written
once at 3.35 TB/s (``e cout (n + batch h w)`` bytes a "resize" layer, ``(h,
w)`` its ``src``); over the device time of the kernels launched under the
port's ``hygrid.resample_backward`` spans (on the autograd thread) in the
traced window (in a training step the logits' resample is the only one
differentiated: the hexify takes no gradient).  None for a model without
the resize, a serving run, or a trace without the span."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.resample_backward",)


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    e, batch = roofline.ESIZE[run.dtype], run.cell.traffic["batch"]
    parts = [roofline.bound(e * l["cout"] * (l["n"] + batch * l["src"][0]
                                             * l["src"][1]), 0.0, run.dtype)
             for l in run.layers if l["op"] == "resize"]
    return roofline_pct(run, parts, SPANS)
