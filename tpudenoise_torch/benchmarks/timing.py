"""Device timing and the card's identity, shared by `chip_smoke.py` and the
profiling entry points."""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def elapsed_ms(calls, device='cuda') -> float:
    """Milliseconds the device takes for the calls, run in order: CUDA
    events on the GPU, the host clock on the CPU."""
    if torch.device(device).type != 'cuda':
        t0 = time.perf_counter()
        for c in calls:
            c()
        return (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for c in calls:
        c()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device time of fn() over iters runs after `warm` untimed ones,
    by CUDA events."""
    for _ in range(warm):
        fn()
    return elapsed_ms([fn] * iters) / iters


# the marker kernel `device_ms` launches around its calls (`spin_kernel`,
# torch.cuda._sleep's): the trace has been seen to drop one kernel record
# at a session's edge on an H100, and then it drops a marker's
MARKER = 'spin_kernel'


def device_ms(fn, iters: int, symbols=None, warm: int = 2,
              per_call: int = 1) -> float | None:
    """Mean device time of fn() over iters runs after `warm` untimed ones,
    from torch.profiler's key_averages: the kernels whose names hold one
    of `symbols` (every kernel but the markers when None).  Unlike
    `time_ms`, host time between the kernels does not count.  The trace
    must hold `per_call` launches of the first symbol's kernel a call: a
    trace that dropped some is taken again, at most twice, and then None
    is returned."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type.name == 'CUDA' and MARKER not in e.key and (
                    symbols is None or any(s in e.key for s in symbols))]
        if symbols is None or sum(e.count for e in kern if symbols[0]
                                  in e.key) == per_call * iters:
            return sum(e.self_device_time_total for e in kern) / iters / 1e3
    return None


def images_per_s(fn, images: torch.Tensor, seeds: torch.Tensor | None,
                 inner: int, reps: int) -> float:
    """Images/s of `inner` calls fn(images, seeds + i) (fn(images) when
    seeds is None), the mean of `reps` timed runs after two warm ones; the
    seeds differ in every call."""
    def calls(r):
        if seeds is None:
            return [lambda: fn(images)] * inner
        steps = [seeds + (1000 * r + i) for i in range(inner)]
        return [lambda s=s: fn(images, s) for s in steps]

    for r in (-2, -1):
        elapsed_ms(calls(r), images.device)
    ms = sum(elapsed_ms(calls(r), images.device) for r in range(reps)) / reps
    return images.shape[0] * inner / (ms / 1e3)
