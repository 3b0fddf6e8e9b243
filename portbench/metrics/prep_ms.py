"""Device milliseconds of the kernels launched inside the prep spans
(prep_on_device: mean subtraction, resize, bucket pad), per chunk."""


def read(ctx):
    n = ctx['layer_count'].get('prep', 0)
    if not n:
        return None
    return ctx['layer_device_s'].get('prep', 0.0) / n * 1e3
