"""Time variants of the stage kernels' walk (kernels 9-11,
`csrc/sap_stages.cu`) against the source as it stands, on one card.

    python3 -m tpudenoise_torch.benchmarks.stage_variants [--reps 2]

Each variant is the source with a few textual edits (`VARIANTS`), built
with the port's nvcc flags into `build/stage_variants/`, loaded in place
of the source's library, and timed by CUDA events on the med1 and full
cases of `profile_noise_kernels.stage_cases` (B = 128): u8, f32 on the
packed start, f32 on the float walk alone, and `kernel_only`'s raster.
The source and the variants run in turns, `--reps` times, and every
variant's output must equal the source's bit for bit.  A variant whose
text no longer matches the source raises.  The last line is the card's
name and power limit; the one before it the results as JSON.  Runs on the
GPU only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.benchmarks import profile_noise_kernels as pnk
from tpudenoise_torch.benchmarks.timing import card_line, time_ms

SOURCE = osp.join(cuda_build.CSRC, 'sap_stages.cu')
OUT = osp.join(osp.dirname(cuda_build.BUILD_ROOT), 'stage_variants')

# name: [(text of the source, its replacement)]
VARIANTS = {
    '800 threads, 2 blocks an SM': [
        ('constexpr int kThreads = 640;', 'constexpr int kThreads = 800;'),
        ('kBlocksPerSm = 3;', 'kBlocksPerSm = 2;')],
    '768 threads, 2 blocks an SM': [
        ('constexpr int kThreads = 640;', 'constexpr int kThreads = 768;'),
        ('kBlocksPerSm = 3;', 'kBlocksPerSm = 2;')],
    'own sorted column re-read from the taps': [
        ('m[k] = merge<R>(tap1[k], w.tl, w.tr, lo[k], mid[k], hi[k]);',
         'm[k] = merge<R>(tap1[k], w.tl, w.tr, tap1[k][0][t], '
         'tap1[k][1][t], tap1[k][2][t]);'),
        ('merge<R>(tap2[k], w.tl, w.tr, lo[k], mid[k], hi[k])',
         'merge<R>(tap2[k], w.tl, w.tr, tap2[k][0][t], tap2[k][1][t], '
         'tap2[k][2][t])')],
    'f32 packed start 4 rows a step': [
        ('struct CheckedPacked : PackedMedian {',
         'struct CheckedPacked : PackedMedian {\n'
         '  static constexpr int kPairs = 2;'),
        ('return 2 * (int)sizeof(Taps<R, kThreads>);',
         'return 2 * (int)sizeof(Taps<FloatMedian, kThreads>);')],
    'streaming loads and stores on the f32 packed start': [
        ('const float v = *p;', 'const float v = __ldcs(p);'),
        ('*p = (float)(m & 0xFFFFu);', '__stcs(p, (float)(m & 0xFFFFu));'),
        ('*p = (float)(m >> 16);', '__stcs(p, (float)(m >> 16));')],
}


def _slug(name: str) -> str:
    return ''.join(c if c.isalnum() else '_' for c in name)


def build(name: str, edits) -> str:
    """The variant's library: the source with `edits`, built as
    cuda_build builds the source."""
    with open(SOURCE) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise ValueError(f'variant {name!r}: {old!r} is not in the '
                             f'source')
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    src = osp.join(OUT, _slug(name) + '.cu')
    so = osp.join(OUT, 'lib' + _slug(name) + '.so')
    with open(src, 'w') as f:
        f.write(text)
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                          '-I', cuda_build.CSRC, '-Xptxas', '-v', '-o', so,
                          src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name!r}:\n{res.stderr}')
    with open(so + '.ptxas.log', 'w') as f:
        f.write(res.stderr)
    return so


def run(reps: int) -> dict:
    """{library: {case: [ms of each rep]}}; the source's first."""
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        sos = dict(zip(VARIANTS, pool.map(build, VARIANTS,
                                          VARIANTS.values())))
    libs = {'source': cuda_build.library('sap_stages'),
            **{k: ctypes.CDLL(v) for k, v in sos.items()}}
    cases = {k: fn for k, (fn, _, _) in pnk.stage_cases('cuda').items()
             if 'med1' in k or 'full' in k}
    want = {k: fn() for k, fn in cases.items()}
    out = {name: {k: [] for k in cases} for name in libs}
    try:
        for rep in range(reps):
            for name, lib in libs.items():
                cuda_build._libs['sap_stages'] = lib
                for case, fn in cases.items():
                    if not torch.equal(fn(), want[case]):
                        raise AssertionError(f'{name!r} differs from the '
                                             f'source on {case!r}')
                    ms = time_ms(fn, 20)
                    out[name][case].append(ms)
                    print(f'{name} | rep {rep} | {case}: {ms:.4f} ms (CUDA '
                          f'events)', flush=True)
    finally:
        cuda_build._libs['sap_stages'] = libs['source']
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('stage_variants: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    print(json.dumps({'card': card, 'ms': run(args.reps)}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
