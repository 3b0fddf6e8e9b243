"""Reduce a profiler trace of the traced rows (torch.profiler's Chrome
trace: host spans, runtime launches, device kernels, copies and sets)
to what the per-layer readers read:

* `busy_s`: the union of the device's kernel, copy and set intervals
  inside the window; `window_s`: the host's 'pb.window' span;
* each device kernel's layer: the 'pb.<layer>' span open on the host
  when its launch was made (runtime event and kernel joined by their
  correlation id), and for the port's own kernels the 'pb.kernel.<entry>'
  span; per layer its device seconds, its host seconds and its count;
* the top device kernels by name and the longest idle gaps, each named
  by the layer span open on the host at the gap's middle ('loop': in
  test_net_batched outside the layer spans: the reader, the host
  copies, the collect).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Spans:
    """Disjoint host intervals of one kind, found by bisection."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)['traceEvents']
    layers, kernels, window = [], [], None
    launch_ts, device = {}, []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, name = e.get('cat', ''), e.get('name', '')
        ts, dur = float(e['ts']), float(e.get('dur', 0.0))
        if cat == 'user_annotation' and name.startswith('pb.'):
            if name == 'pb.window':
                window = (ts, ts + dur)
            elif name.startswith('pb.kernel.'):
                kernels.append((ts, ts + dur, name[len('pb.kernel.'):]))
            else:
                layers.append((ts, ts + dur, name[len('pb.'):]))
        elif cat == 'cuda_runtime' and 'correlation' in e.get('args', {}):
            launch_ts[e['args']['correlation']] = ts
        elif cat in DEVICE_CATS:
            device.append(e)
    if window is None:
        raise RuntimeError('the trace holds no pb.window span')
    w0, w1 = window
    lay, ker = Spans(layers), Spans(kernels)
    host_s, count = defaultdict(float), defaultdict(int)
    for s, e, n in layers:
        host_s[n] += (e - s) * 1e-6
        count[n] += 1
    dev_s, entry_s, by_name = defaultdict(float), defaultdict(float), \
        defaultdict(float)
    intervals = []
    for e in device:
        ts, dur = float(e['ts']), float(e.get('dur', 0.0))
        s, t = max(ts, w0), min(ts + dur, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        lt = launch_ts.get(e.get('args', {}).get('correlation'))
        layer = lay.at(lt) if lt is not None else None
        dev_s[layer or 'other'] += (t - s) * 1e-6
        if e['cat'] == 'kernel':
            by_name[e['name'][:120]] += (t - s) * 1e-6
            entry = ker.at(lt) if lt is not None else None
            if entry is not None:
                entry_s[entry] += (t - s) * 1e-6
    busy = _union(intervals)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, lay.at(0.5 * (prev + s)) or 'loop'))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {'window_s': (w1 - w0) * 1e-6,
            'busy_s': sum(e - s for s, e in busy) * 1e-6,
            'layer_host_s': dict(host_s), 'layer_count': dict(count),
            'layer_device_s': dict(dev_s), 'entry_device_s': dict(entry_s),
            'breakdown': {
                'device_ops': [[n, s] for n, s in top],
                'idle_gaps': [[n, d * 1e-6] for d, n in gaps[:10]]}}
