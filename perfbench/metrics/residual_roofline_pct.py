"""The residual joins (`models/deeplab.py::residual_join`: relu(a + b), and
its backward, the output gradient masked by the output and handed to both
inputs) against their bound: each join's two inputs read and its output
written once forward, its output gradient and output read and the input
gradient written once backward (``3 e n c`` bytes each way, the "join"
layers' ``n`` cells of ``cout`` channels) at 3.35 TB/s; over the device
time of the kernels launched under the port's ``hygrid.residual`` and
``hygrid.residual_backward`` spans in the traced window.  None for a model
without joins, a serving run, or a trace without the spans."""
from perfbench import roofline
from perfbench.readers import roofline_pct

SPANS = ("hygrid.residual", "hygrid.residual_backward")


def read(run):
    if run.cell.loop.KIND != "train":
        return None
    e = roofline.ESIZE[run.dtype]
    parts = [roofline.bound(3 * e * l["n"] * l["cout"], 0.0, run.dtype)
             for l in run.layers if l["op"] == "join" for _ in range(2)]
    return roofline_pct(run, parts, SPANS)
