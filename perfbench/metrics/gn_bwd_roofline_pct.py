"""The GN/ReLU backward (`csrc/gn_backward.cu`, one launch a GN layer)
against its bound: each GN layer's float32 pre-activation and output
gradient read and its pre-activation gradient written once at 3.35 TB/s
(``4 n cout + 2 e n cout`` bytes, the GN part of
``roofline.conv_backward_parts``); over the device time of the kernels
launched under the port's ``hygrid.gn_backward`` spans (on the autograd
thread) in the traced window.  A serving run, or a trace without the span,
reads nothing."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.gn_backward",)


def gn_parts(run):
    if run.cell.cfg.get("norm") != "GN":
        return []
    e = roofline.ESIZE[run.dtype]
    return [roofline.bound((4 + 2 * e) * l["n"] * l["cout"], 0.0, run.dtype)
            for l in run.layers if l["op"] in roofline.CONVS]


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    return roofline_pct(run, gn_parts(run), SPANS)
