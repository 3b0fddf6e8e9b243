"""Row-by-row difference of two noise-grid results files.

    python -m tpudenoise_torch.experiments.grid_diff \\
        [--port tpudenoise_torch/experiments/RESULTS.json] \\
        [--reference RESULTS.json]

Prints a markdown table of each row the two files share: AP@.5 and
AP@[.5,.95] of both, and the port's minus the reference's, then the
largest |difference| of each.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(osp.dirname(HERE))
KEYS = ('AP@.5', 'AP@[.5,.95]')


def diff_rows(port: dict, reference: dict) -> list:
    """[(noise, port AP@.5, ref AP@.5, diff, port AP@[.5,.95], ref, diff)]
    over the reference's rows that the port has, in the reference's
    order."""
    mine = {r['noise']: r for r in port['results']}
    out = []
    for r in reference['results']:
        p = mine.get(r['noise'])
        if p is None:
            continue
        row = [r['noise']]
        for k in KEYS:
            row += [p[k], r[k], round(p[k] - r[k], 4)]
        out.append(tuple(row))
    return out


def table(rows: list) -> str:
    lines = ['| noise config | AP@.5 port | AP@.5 JAX | diff '
             '| AP@[.5,.95] port | AP@[.5,.95] JAX | diff |',
             '|---|---|---|---|---|---|---|']
    for r in rows:
        lines.append(f'| {r[0]} | ' + ' | '.join(
            f'{v:+.4f}' if i in (3, 6) else f'{v:.4f}'
            for i, v in enumerate(r) if i) + ' |')
    if rows:
        lines.append('')
        lines.append(f'max |diff|: AP@.5 {max(abs(r[3]) for r in rows):.4f}'
                     f', AP@[.5,.95] {max(abs(r[6]) for r in rows):.4f} '
                     f'over {len(rows)} rows')
    return '\n'.join(lines)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--port', default=osp.join(HERE, 'RESULTS.json'))
    p.add_argument('--reference', default=osp.join(REPO, 'RESULTS.json'))
    args = p.parse_args(argv)
    with open(args.port) as f:
        port = json.load(f)
    with open(args.reference) as f:
        reference = json.load(f)
    out = table(diff_rows(port, reference))
    print(out)
    return out


if __name__ == '__main__':
    main()
