"""Run one cell of the port's benchmark once and print its JSON line.

Set-up (timed from the start of `run.py` to the first timed row):
the cell's rrData split written under TMPDIR from the seed
(`dataset.py`), the program's FasterRCNN on the card with the weights
made from the seed on the card (`weights.py`), the hooks of `spans.py`,
and one warm row of each noise string of the traffic mix.

The window: rows back to back, one closed-loop sweep.  Row r is one
`tpudenoise_torch.eval.harness.test_net_batched` call over the whole
split with the mix's string r (cycled) and cfg.RNG_SEED
`check.row_seed(seed, r)`.  The window closes at the end of the first
row that ends `--seconds` or more after the first row began (and not
before the rows the check samples have run); that row counts.  With
`--trace 1` the first rows of the window (at least 8 and at least one of
each string) run under torch.profiler, and the per-layer metrics are
read from that trace (`trace.py`, `metrics/*.py`), but for `mfu_pct`,
which is read from the rows after the trace by the host's clock (at
least one: the window does not close before one has run).  The traced
rows' and the later rows' median times are printed on stderr: the
profiler's cost to a row.

Then the peak memory is read, the program is freed, and `check.py`
judges the sampled chunks against the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import spec as S

REFUSED = ('jax', 'jaxlib', 'flax', 'tpudenoise')
CACHE = osp.join(S.ROOT, 'build', 'portbench')
TRACE_ROWS = 8


def cache_env(environ=os.environ) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds go to build/tpudenoise_torch/ there)."""
    environ['TORCH_EXTENSIONS_DIR'] = osp.join(CACHE, 'torch_extensions')
    environ['TRITON_CACHE_DIR'] = osp.join(CACHE, 'triton')
    environ['CUDA_CACHE_PATH'] = osp.join(CACHE, 'nv')
    environ['USE_FLAX'] = '0'


def refused(names) -> list:
    """The refused top-level names among module names (whole names: the
    part before the first dot)."""
    return sorted({n.split('.')[0] for n in names} & set(REFUSED))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def program_cfg(conf: dict, data_dir: str, root_dir: str):
    """The program's config for a configuration file, its data and
    artifacts under root_dir."""
    from tpudenoise_torch.core.config import default_config
    C = default_config()
    C.DATA_DIR, C.ROOT_DIR = data_dir, root_dir
    C.TEST.SCALES = tuple(conf['test_scales'])
    C.TEST.MAX_SIZE = conf['test_max_size']
    C.TEST.NMS = conf['test_nms']
    C.TEST.MODE = 'nms'
    C.TEST.RPN_NMS_THRESH = conf['rpn_nms_thresh']
    C.TEST.RPN_PRE_NMS_TOP_N = conf['rpn_pre_nms_top_n']
    C.TEST.RPN_POST_NMS_TOP_N = conf['rpn_post_nms_top_n']
    C.RESNET.MAX_POOL = conf['resnet_max_pool']
    C.POOLING_SIZE = conf['pooling_size']
    C.RPN_CHANNELS = conf['rpn_channels']
    C.PIXEL_MEANS = np.array([[conf['pixel_means']]])
    return C


class Cell:
    """One cell's set-up on a device: dataset, program, weights, hooks;
    `row(r, noise)` runs one row."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device,
                 tmp: str):
        from portbench import check, dataset, spans, weights
        from tpudenoise_torch.models.faster_rcnn import FasterRCNN
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = device
        self.ds = dataset.write(osp.join(tmp, 'data'), traffic['images'],
                                traffic['image_hw'], seed)
        self.C = program_cfg(conf, self.ds['data_dir'], tmp)
        model = FasterRCNN(conf['net'], num_classes=conf['num_classes'],
                           anchor_scales=conf['anchor_scales'],
                           anchor_ratios=conf['anchor_ratios'],
                           cfg=self.C).to(device)
        self.layout = weights.layout(model.state_dict())
        model.load_state_dict(weights.make(self.layout, seed, device))
        self.model, self.params = model, model.state_dict()
        self.strings = traffic['rows']
        self.n_chunks = math.ceil(traffic['images'] / traffic['eval_batch'])
        self.rec = spans.Recorder(check.sample(
            seed, len(self.strings), traffic['check_rows'], self.n_chunks))
        self.restore = spans.install(self.rec, model)

    def row(self, r: int, noise: str):
        from portbench import check
        from tpudenoise_torch.data.voc_like import rrData
        from tpudenoise_torch.eval import harness as H
        rng = check.row_seed(self.seed, r)
        self.rec.start_row(r, noise, rng)
        self.C.RNG_SEED = rng
        imdb = rrData('test', '2021', config=self.C,
                      pixel_dir=self.ds['pixel_dir'])
        imdb.competition_mode(True)
        return H.test_net_batched(
            self.model, self.params, imdb, f'{self.conf["net"]}_{noise}',
            noise, eval_batch=self.traffic['eval_batch'],
            max_per_image=self.conf['max_per_image'],
            thresh=self.conf['thresh'], config=self.C,
            bucket=tuple(self.conf['bucket']))

    def warm(self):
        for j, noise in enumerate(dict.fromkeys(self.strings)):
            self.row(-1 - j, noise)

    def kept_chunks(self) -> list:
        """The sampled chunks the rows completed, for `check.judge`."""
        out = []
        for (r, _), k in sorted(self.rec.kept.items()):
            if {'noisy', 'rpn', 'fwd', 'dets'} <= set(k):
                noise, rng = self.rec.meta[r]
                out.append(dict(k, noise=noise, rng_seed=rng, row=r))
        return out

    def free_program(self):
        import torch
        self.restore()
        del self.model, self.params
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def window(cell: Cell, seconds: float, trace: bool, tmp: str) -> dict:
    """The measured rows; with trace, the first rows under the
    profiler, its Chrome trace written under tmp."""
    import torch
    strings = cell.strings
    n_trace = max(TRACE_ROWS, len(strings)) if trace else 0
    least = n_trace + 1 if trace else 0       # rows before the close
    times, failed, r, prof, span = [], 0, 0, None, None
    t_first = t_after = time.perf_counter()
    while True:
        if r == 0 and trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if cell.device.type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            cell.rec.tracing = True
            span = torch.profiler.record_function('pb.window')
            span.__enter__()
        t0 = time.perf_counter()
        aps = cell.row(r, strings[r % len(strings)])
        t1 = time.perf_counter()
        times.append(t1 - t0)
        failed += not np.all(np.isfinite(np.asarray(aps, np.float64)))
        r += 1
        if r == n_trace:
            span.__exit__(None, None, None)
            cell.rec.tracing = False
            prof.__exit__(None, None, None)
            t_after = time.perf_counter()
        if (t1 - t_first >= seconds and r >= least
                and r > max(cell.rec.sample)):
            break
    out = {'t_first': t_first, 'rows': r, 'times': times, 'failed': failed,
           'elapsed': t1 - t_first, 'n_trace': n_trace,
           'untraced_rows': r - n_trace, 'untraced_s': t1 - t_after}
    if trace:
        out['trace_path'] = osp.join(tmp, 'trace.json')
        prof.export_chrome_trace(out['trace_path'])
    return out


def run(c: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """The cell's result line (a dict), and the check's lines."""
    tmp = tempfile.mkdtemp(prefix='portbench-')
    try:
        return _run(c, seed, seconds, trace, device, t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _run(c, seed, seconds, trace, device, t_start, tmp):
    import torch

    from portbench import check, flops, weights
    from portbench import trace as T
    conf, traffic = c['config'], c['traffic']
    with open(os.devnull, 'w') as sink, contextlib.redirect_stdout(sink):
        cell = Cell(conf, traffic, seed, device, tmp)
        cell.warm()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        w = window(cell, seconds, trace, tmp)
    _sync(device)
    cuda = device.type == 'cuda'
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    images = traffic['images']
    values = {'setup_s': setup_s,
              'img_per_s': w['rows'] * images / w['elapsed'],
              'row_s_p90': float(np.percentile(w['times'], 90))}
    print(f'rows in the window: {w["rows"]} ({images} images each), row s '
          f'median {float(np.median(w["times"])):.4f} p90 '
          f'{values["row_s_p90"]:.4f}', file=sys.stderr)
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': False, 'attempted': w['rows'], 'failed': w['failed']}
    if trace:
        ctx = T.reduce(w['trace_path'])
        ctx.update(launches=cell.rec.launches, rows=w['n_trace'],
                   chunks=ctx['layer_count'].get('noise', 0),
                   images=w['n_trace'] * images,
                   flops_per_image=flops.per_image(conf),
                   untraced_images=w['untraced_rows'] * images,
                   untraced_s=w['untraced_s'])
        n = w['n_trace']
        print(f'traced rows: {n}, row s median '
              f'{float(np.median(w["times"][:n])):.4f}; rows after the '
              f'trace: {w["untraced_rows"]}, row s median '
              f'{float(np.median(w["times"][n:])):.4f}', file=sys.stderr)
        metrics = {}
        for m in c['per_layer']:
            v = S.metric(m['name']).read(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        dev.update(busy_s=ctx['busy_s'], window_s=ctx['window_s'])
        result['metrics'] = metrics
        result['breakdown'] = ctx['breakdown']
    else:
        result['metrics'] = {m['name']: {'value': values[m['name']],
                                         'unit': m['unit']}
                             for m in c['end_to_end']}
    result['device'] = dev
    chunks = cell.kept_chunks()
    cell.free_program()
    sd = weights.make(cell.layout, seed, device)
    numbers = check.judge(chunks, cell.ds, sd, conf, device)
    ok, rows = check.verdict(numbers, c['limits'])
    result['correct'] = bool(ok and chunks and w['failed'] == 0)
    print(f'chunks compared: {len(chunks)} (rows '
          f'{[k["row"] for k in chunks]})', file=sys.stderr)
    print('not compared: ' + ', '.join(
        f'{k} {v}' for k, v in numbers['drift'].items()), file=sys.stderr)
    result['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim in rows}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cache_env()
    import torch
    c = S.cell(args.workload)
    chips = c['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: needs {chips} CUDA device(s), found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              f'; no result', file=sys.stderr)
        return 2
    print(f'card: {card_line()}', file=sys.stderr)
    result = run(c, args.seed, args.seconds, bool(args.trace),
                 torch.device('cuda', 0), t_start)
    found = refused(sys.modules)
    if found:
        print(f'portbench: refused modules loaded: {found}; no result',
              file=sys.stderr)
        return 3
    for name, v in result['checks'].items():
        print(f'check {name}: {v["value"]} (limit {v["limit"]})',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
