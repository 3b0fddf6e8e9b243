"""The readings that the limits of `check.py` are set from, at a cell's
own size, many seeds in one process:

    python3 portbench/readings.py --workload <cell> --side program \
        --seeds 1,2,3 [--out readings.jsonl]
    python3 portbench/readings.py --workload <cell> --side control ...

--base-seed N draws the network whole from N in place of
`weights.BASE_SEED` (the seeds then jitter that network): readings on a
network that the limits were not read on.

program: per seed the cell's set-up and warm rows, then the window's
rows up to the last sampled one through the timed path (no window is
timed), then
`check.judge` of the sampled chunks.  control: the reference put in the
program's place one step below each stage's precision
(`check.control_chunks`) over the same chunks, judged the same way.
One JSON line per seed."""

import argparse
import json
import os.path as osp
import sys
import tempfile
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from portbench import spec as S  # noqa: E402


def chunks_of(cell) -> list:
    """The sampled chunks' descriptors without running the program."""
    from portbench import check
    b = cell.traffic['eval_batch']
    out = []
    for r, c in sorted(cell.rec.sample.items()):
        out.append({'row': r, 'idx': list(range(c * b, (c + 1) * b)),
                    'noise': cell.strings[r % len(cell.strings)],
                    'rng_seed': check.row_seed(cell.seed, r)})
    return out


def one(c: dict, seed: int, side: str, device) -> dict:
    import contextlib
    import os
    import shutil

    import torch

    from portbench import check, harness, weights
    tmp = tempfile.mkdtemp(prefix='portbench-')
    t0 = time.perf_counter()
    try:
        with open(os.devnull, 'w') as sink, contextlib.redirect_stdout(sink):
            cell = harness.Cell(c['config'], c['traffic'], seed, device, tmp)
            if side == 'program':
                cell.warm()
                for r in range(max(cell.rec.sample) + 1):
                    cell.row(r, cell.strings[r % len(cell.strings)])
                chunks = cell.kept_chunks()
            cell.free_program()
        sd = weights.make(cell.layout, seed, device)
        if side == 'control':
            chunks = check.control_chunks(chunks_of(cell), cell.ds, sd,
                                          c['config'], device)
        numbers = check.judge(chunks, cell.ds, sd, c['config'], device)
        f = chunks[0]['fwd']
        stats = {'cls_score_std': float(f['cls_score'].std()),
                 'rois_per_image': float(f['roi_mask'].sum(1).float().mean()),
                 'dets_per_image': float(sum(
                     len(d) for im in chunks[0]['dets'] for d in im))
                 / len(chunks[0]['dets'])}
        del sd, chunks
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        return {'seed': seed, 'side': side, 'numbers': numbers,
                'stats': stats, 'seconds': time.perf_counter() - t0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--side', choices=('program', 'control'), required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--out', default=None)
    p.add_argument('--base-seed', type=int, default=None)
    args = p.parse_args(argv)
    from portbench import harness, weights
    harness.cache_env()
    if args.base_seed is not None:
        weights.BASE_SEED = args.base_seed
    import torch
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 2
    c = S.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        line = json.dumps(dict(one(c, seed, args.side,
                                   torch.device('cuda', 0)),
                               workload=args.workload,
                               base_seed=weights.BASE_SEED))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
