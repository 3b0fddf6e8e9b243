"""Time the two bilateral kernels through the port's wrappers: kernel 5
(the standalone bilateral, `denoise/bilateral.py:bilateral_batched`) and
kernel 7 (mixed noise + bilateral, `noise/mix_kernels.py:
fused_mix_bilateral`), at the main paths' shapes, in milliseconds by CUDA
events (host time between the launches included) and by torch.profiler
device time (the kernels alone).

    python3 -m tpudenoise_torch.benchmarks.profile_bilateral

Inputs: kernel 5 on (8, 600, 1000, 3) float32 u8 values (its table form)
and on [0, 1] floats (the gaussian kind's output: its per-tap expf form);
kernel 7 on the kernel checks' 16 images (`MIX_ENTRIES`, all 13 kinds)
and on 8 images drawn by `noise_mix_var_all_bilateral`'s own plan (chunk
0).  Each case also prints a hash of the output, so that two versions of
the port, run one after the other on the same card, can be shown to give
the same bits.  The script uses only the wrappers and the prologue, which
the port has had since its mix kernels came: to time an older tree, copy
this file and `timing.py` into its `tpudenoise_torch/benchmarks/` and run
it there.  The last line is the card's name and power limit; the one
before it the results as JSON.  Runs on the GPU only.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

from tpudenoise_torch.benchmarks.timing import card_line, device_ms, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.denoise import bilateral as bil
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise.mix_prologue import (fixed_prologue, mix_prologue,
                                                 plan_tables)
from tpudenoise_torch.noise.spec import Kind, parse

B, H, W = 8, 600, 1000
# the kernel checks' 16 images: one per kind, levels from the var_all
# table, then brownian, periodic and quant at a second level: (Kind
# value, level)
MIX_ENTRIES = [(0, 0.0), (1, 1.0), (2, 0.0), (3, 0.8), (4, 2.0), (5, 7.0),
               (6, 1.2), (7, 0.9), (8, 100.0), (9, 0.2), (10, 0.3),
               (11, 0.0), (12, 0.0), (7, 0.009), (8, -1.0), (5, 10.0)]
MIX_PLAN = 'noise_mix_var_all_bilateral'
SYMBOLS = {'bilateral': ('bilateral_kernel',),
           'mix_bilateral': ('mix_bilateral_kernel', 'brownian_')}


def bilateral_inputs(dev) -> dict:
    """Kernel 5's inputs: u8 values with a zero band (as clipped noise
    makes), and [0, 1] floats."""
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    u8[:, :, :7] = 0.0
    unit = rng.uniform(0.0, 1.0, (B, H, W, 3)).astype(np.float32)
    return {'u8 values': torch.from_numpy(u8).to(dev),
            '[0, 1] floats': torch.from_numpy(unit).to(dev)}


def mix_inputs(dev, entries, seed: int = 5):
    """(raw, kinds, args) for images i taking entries[i] = (kind, level),
    as the kernel checks build them."""
    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, 256, (len(entries), H, W, 3))
                           .astype(np.uint8)).to(dev)
    kinds, *args = fixed_prologue(prng.split(prng.PRNGKey(seed),
                                             len(entries)), raw, entries)
    return raw, kinds, args


def plan_inputs(dev, seed: int = 3):
    """(raw, kinds, args, drawn) for the first chunk (images 0-7) of
    `MIX_PLAN`, keyed as detect_chunk keys it; drawn: kind name per
    image."""
    rng = np.random.RandomState(seed)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    kinds, eb, el = plan_tables(parse(MIX_PLAN).specs)
    keys = np.asarray(prng.fold_in(prng.PRNGKey(default_config().RNG_SEED),
                                   np.arange(B)), np.uint32).reshape(-1, 2)
    args = mix_prologue(prng.split(keys, 1)[:, 0], raw, kinds, eb, el)
    drawn = [Kind(kinds[i]).name.lower() for i in args[0].tolist()]
    return raw, kinds, args, drawn


def profile(dev, iters: int = 10) -> dict:
    """{case: {ms, device_ms, output_sha256}} for every case."""
    cases = {f'bilateral {k}': ('bilateral', lambda v=v:
                                bil.bilateral_batched(v))
             for k, v in bilateral_inputs(dev).items()}
    raw, kinds, args = mix_inputs(dev, MIX_ENTRIES)
    cases['mix_bilateral 16 check images'] = (
        'mix_bilateral', lambda: mk.fused_mix_bilateral(raw, *args, kinds))
    praw, pkinds, pargs, drawn = plan_inputs(dev)
    cases[f'mix_bilateral {MIX_PLAN} chunk 0 ({", ".join(drawn)})'] = (
        'mix_bilateral', lambda: mk.fused_mix_bilateral(praw, *pargs,
                                                        pkinds))
    out = {}
    for case, (kernel, fn) in cases.items():
        sha = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        out[case] = t = dict(ms=time_ms(fn, iters),
                             device_ms=device_ms(fn, iters, SYMBOLS[kernel]),
                             output_sha256=sha)
        print(f'{case}: {t["ms"]:.4f} ms (CUDA events), {t["device_ms"]} ms '
              f'(profiler device time), output {sha}', flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_bilateral: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    print(json.dumps({'card': card, 'results': profile('cuda')}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
