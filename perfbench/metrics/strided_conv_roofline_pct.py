"""The strided hex convs with their GroupNorm (`models/deeplab.py::
HexConv2dGN`: `HexConv2d(stride=2)`, cuDNN's per-parity convolutions, then
GN and ReLU) against their bound: each "sconv" layer's input (``n_in``
cells), weights and output read or written once at 3.35 TB/s, or its
products at the dtype's peak (``roofline.layer_flops``), whichever is
longer (``roofline.bound``); over the device time of the kernels launched
under the port's ``hygrid.conv_strided`` spans (the forward; the backward
runs under torch's autograd nodes) in the traced window.  None for a model
without strided convs, a serving run, or a trace without the span."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.conv_strided",)


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    e = roofline.ESIZE[run.dtype]
    parts = [roofline.bound(e * (l["n_in"] * l["cin"] + l["n"] * l["cout"]
                                 + l["cin"] * l["cout"] * l["taps"]),
                            roofline.layer_flops(l), run.dtype)
             for l in run.layers if l["op"] == "sconv"]
    return roofline_pct(run, parts, SPANS)
