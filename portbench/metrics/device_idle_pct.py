"""The share of the traced window in which no kernel, copy or set runs
on the device (the union of the device's timeline)."""


def read(ctx):
    return 100.0 * (1.0 - ctx['busy_s'] / ctx['window_s'])
