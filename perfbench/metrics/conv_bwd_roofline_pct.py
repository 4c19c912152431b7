"""The hex conv layers' backward (the GN backward, `csrc/gn_backward.cu`;
dx on `csrc/hex_conv_layer.cu`; dW, `csrc/hex_conv_wgrad.cu`) against its
bound: the GN backward's bytes, dx's and dW's operations (or bytes, where
longer), from the layer shapes; over the device time of every kernel
launched under the `_HexConvLayerBackward` autograd node in the traced
window (a serving run launches none, and reads nothing)."""
from perfbench import roofline
from perfbench.readers import roofline_pct

OPS = ("_HexConvLayerBackward",)


def read(run):
    return roofline_pct(run,
                        roofline.conv_backward_parts(run.layers, run.dtype),
                        OPS)
