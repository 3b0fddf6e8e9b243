"""Device milliseconds of the kernels launched inside the noise spans
(noise_chunk: keys, draws, the noise and denoise kernels and ops), per
chunk."""


def read(ctx):
    n = ctx['layer_count'].get('noise', 0)
    if not n:
        return None
    return ctx['layer_device_s'].get('noise', 0.0) / n * 1e3
