"""Host milliseconds inside the forward spans per chunk: the time the
host takes to enqueue the forward, which paces the chunk where it is
longer than the device's."""


def read(ctx):
    n = ctx['layer_count'].get('forward', 0)
    return ctx['layer_host_s']['forward'] / n * 1e3 if n else None
