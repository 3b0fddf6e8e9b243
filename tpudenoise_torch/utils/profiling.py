"""Profiling hooks (counterpart of `tpudenoise/utils/profiling.py`):
`trace(logdir)` records the enclosed block with torch.profiler (host and
CUDA activities) and writes a Chrome trace into logdir, as
`jax.profiler.trace` does for the JAX package; open it in
ui.perfetto.dev or chrome://tracing."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the enclosed block into `logdir/trace_<time>.json` when
    logdir is set; no-op otherwise.  CUDA activity is recorded where
    torch sees a GPU."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f'trace_{time.strftime("%Y%m%d_%H%M%S")}_'
                                f'{os.getpid()}.json')
    prof.export_chrome_trace(path)
    print(f'[profiler] trace written to {path}')


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)
