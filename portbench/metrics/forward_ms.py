"""Device milliseconds of the kernels launched inside the forward spans
(FasterRCNN.forward_test: backbone, RPN, proposals with kernel 3 and
the walk, crops, tail, heads), per chunk."""


def read(ctx):
    n = ctx['layer_count'].get('forward', 0)
    if not n:
        return None
    return ctx['layer_device_s'].get('forward', 0.0) / n * 1e3
