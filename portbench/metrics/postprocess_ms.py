"""Device milliseconds of the kernels launched inside the postprocess
spans (decode and the per-class NMS), per chunk."""


def read(ctx):
    n = ctx['layer_count'].get('postprocess', 0)
    if not n:
        return None
    return ctx['layer_device_s'].get('postprocess', 0.0) / n * 1e3
