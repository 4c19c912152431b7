"""Kernel B's forward (`csrc/hex_conv_layer.cu`, the split mode
included) against its bound: every hex conv layer's input, weights, float32
pre-activation and output once at 3.35 TB/s, or its operations at the
dtype's peak, whichever is longer; over the device time of every kernel
launched under the ``hygrid::hex_conv_layer`` op in the traced window."""
from perfbench import roofline
from perfbench.readers import roofline_pct

OPS = ("hygrid::hex_conv_layer",)


def read(run):
    return roofline_pct(run,
                        roofline.conv_forward_parts(run.layers, run.dtype),
                        OPS)
