"""The port's hand-written kernels in the traced rows: the sum of each
launch's least time (kernels/<entry>.py, from its arguments) over the
sum of their device time in the trace (the kernels launched inside the
'pb.kernel.<entry>' spans)."""

import sys


def read(ctx):
    from portbench import spec
    device = sum(ctx['entry_device_s'].values())
    if not ctx['launches'] or device <= 0:
        return None
    least = 0.0
    for entry, args in ctx['launches']:
        mod = spec.kernel(entry)
        s = mod.cost(args) if mod is not None else None
        if s is None:
            print(f'kernel_roofline_pct: no count for {entry}; counted as 0',
                  file=sys.stderr)
            continue
        least += s
    return 100.0 * least / device
