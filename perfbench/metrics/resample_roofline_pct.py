"""The rect->hex resample (`models/train.py::hexify_batch`: the
`csrc/plan_gather.cu` launch and its host code) against its bound: the rect
pixels the plan blends with a weight other than 0 read once (the plain
reference's own plan, `reference/hexlib.py::rect_to_hex_plan`) and the hex
batch written once at 3.35 TB/s; over the device time of the kernels
launched under the port's ``hygrid.hexify`` spans in the traced window;
None where the trace holds no such span."""
import numpy as np

from perfbench import roofline
from perfbench.readers import roofline_pct
from perfbench.reference.hexlib import rect_to_hex_plan

SPANS = ("hygrid.hexify",)


def resample_parts(cfg, traffic, dtype: str):
    idx, wts = rect_to_hex_plan(*cfg["image"], *cfg["hex"])
    read = np.unique(idx[wts != 0]).size
    h1, w1 = cfg["hex"]
    cells = traffic["batch"] * cfg["in_channels"] * (read + h1 * w1)
    return [roofline.bound(roofline.ESIZE[dtype] * cells, 0.0, dtype)]


def read(run):
    return roofline_pct(run, resample_parts(run.cell.cfg, run.cell.traffic,
                                            run.dtype), SPANS)
