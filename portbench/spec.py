"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root,
`configs/<name>.json`, `traffic/<name>.json`, `limits/<cell>.json`,
`metrics/<name>.py` and `kernels/<entry>.py` beside this file."""

from __future__ import annotations

import importlib
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(osp.join(root, 'BENCHMARK.json'))


def config(name: str) -> dict:
    return _json(osp.join(HERE, 'configs', name + '.json'))


def traffic(name: str) -> dict:
    return _json(osp.join(HERE, 'traffic', name + '.json'))


def limits(workload: str) -> dict:
    """The limits of a cell's compared numbers, with the readings they
    were set from."""
    return _json(osp.join(HERE, 'limits', workload + '.json'))


def metric(name: str):
    """The reader module of a per-layer metric: read(ctx) -> float |
    None."""
    return importlib.import_module(f'portbench.metrics.{name}')


def kernel(entry: str):
    """The cost module of a kernel entry of the program's `cuda_build`
    (its least time from the launch's arguments), or None."""
    if not osp.exists(osp.join(HERE, 'kernels', entry + '.py')):
        return None
    return importlib.import_module(f'portbench.kernels.{entry}')


def cell(workload: str, bench: dict | None = None) -> dict:
    """The cell's BENCHMARK.json entry with its configuration, traffic
    and limits loaded, and the metrics it reports: {'cell', 'config',
    'traffic', 'limits', 'end_to_end', 'per_layer'}."""
    bench = bench or benchmark()
    found = [w for w in bench['workloads'] if w['name'] == workload]
    if not found:
        raise SystemExit(f'unknown workload {workload!r}')
    w = found[0]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]

    return {'cell': w, 'config': config(w['config']),
            'traffic': traffic(w['traffic']), 'limits': limits(workload),
            'end_to_end': mine(bench['end_to_end']),
            'per_layer': mine(bench['per_layer'])}
