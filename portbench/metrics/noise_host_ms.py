"""Host milliseconds inside the noise spans per chunk: the enqueue, and
the host's own work of the routes that have some (quant palettes, the
mix prologue's tables)."""


def read(ctx):
    n = ctx['layer_count'].get('noise', 0)
    return ctx['layer_host_s']['noise'] / n * 1e3 if n else None
