"""The share of HexUNet's transposed convs spent outside their convolutions:
100 x (device seconds under the port's ``hygrid.conv_transpose`` spans
minus those under their ``hygrid.conv_transpose.subconv`` spans, cuDNN's
sub-convolutions) over the device seconds under ``hygrid.conv_transpose``,
in the traced window (the forward): the layout changes, pads, stacks and
phase interleaves.  None where the trace holds no such span."""

SPANS = ("hygrid.conv_transpose",)
SUBCONV = ("hygrid.conv_transpose.subconv",)


def read(run):
    if run.trace is None:
        return None
    whole = run.trace.op_device_s(SPANS)
    if whole <= 0:
        return None
    return 100.0 * (whole - run.trace.op_device_s(SUBCONV)) / whole
