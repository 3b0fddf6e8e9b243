"""Time the threefry draw kernel and the bloom kernel (kernel 8) through
the port's wrappers, at the main paths' shapes, in milliseconds by CUDA
events (host time between the launches included) and by torch.profiler
device time (the kernels alone).

    python3 -m tpudenoise_torch.benchmarks.profile_noise_kernels

Cases:
  * `core/prng.py:threefry_draw` in its three modes for 8 keys x 1.8M
    words (one (8, 600, 1000, 3) field: the speckle draw is the normal
    one) and the uniform draw for 64 keys x 1.8M (poisson's PTRS rounds:
    8 images x 4 rounds x 2 fields);
  * the summed threefry device time of one poisson noise stage on 8
    images of 600x1000 (its three draws: 8, 8 and 64 keys);
  * `noise/bloom.py:bloom_batched` on (8, 600, 1000, 3) u8 and f32
    images with `bloom_params` params;
  * the bloom kind of the mix kernels 6 and 7 (`bloom_steps.cuh` is
    shared): 8 images that all draw bloom.
Each case also prints a hash of the output, so that two versions of the
port, run one after the other on the same card, can be shown to give the
same bits.  The script uses only entry points that the port has had since
its threefry kernel came: to time an older tree, copy this file and
`timing.py` into its `tpudenoise_torch/benchmarks/` and run it there.  The
last line is the card's name and power limit; the one before it the
results as JSON.  Runs on the GPU only.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

from tpudenoise_torch.benchmarks import profile_bilateral as pb
from tpudenoise_torch.benchmarks.timing import card_line, device_ms, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import bloom as bl
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise.generators import bloom_params
from tpudenoise_torch.noise.pipeline import make_pipeline

B, H, W = 8, 600, 1000
N = H * W * 3
PTRS_KEYS = 64          # poisson's PTRS draw: B images x 4 rounds x 2
THREEFRY = ('threefry_kernel',)
BLOOM = ('bloom_kernel',)
BLOOM_KIND = 11         # Kind.BLOOM


def threefry_cases(dev) -> dict:
    """{case: (fn, symbols, launches a call)} for the threefry draws."""
    keys = torch.from_numpy(prng.split(prng.PRNGKey(11), B).astype(
        np.int64)).to(dev)
    ptrs = torch.from_numpy(prng.split(prng.PRNGKey(12), PTRS_KEYS).astype(
        np.int64)).to(dev)
    sqrt2 = float(prng._SQRT2)
    cases = {f'threefry {mode} {B} x {N}': (
        lambda mode=mode: prng.threefry_draw(keys, N, mode, 0.0, 1.0, sqrt2),
        THREEFRY, 1) for mode in ('bits', 'uniform', 'normal')}
    cases[f'threefry uniform {PTRS_KEYS} x {N} (poisson PTRS)'] = (
        lambda: prng.threefry_draw(ptrs, N, 'uniform'), THREEFRY, 1)
    return cases


def poisson_case(dev) -> dict:
    """The threefry draws of one poisson noise stage (~400 other kernels
    run beside them), keyed as detect_chunk keys chunk 0."""
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    poisson = make_pipeline('poisson')
    chunk_keys = prng.fold_in(prng.PRNGKey(0), np.arange(B))
    return {'threefry in one poisson noise stage (8 images)': (
        lambda: poisson.keyed(chunk_keys, raw), THREEFRY, 3)}


def bloom_cases(dev) -> dict:
    """{case: (fn, symbols, launches a call)} for kernel 8 and the bloom
    kind of kernels 6 and 7."""
    rng = np.random.RandomState(5)
    u8 = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    f32 = u8.to(torch.float32)
    params = torch.from_numpy(bloom_params(prng.split(prng.PRNGKey(6), B),
                                           H, W)).to(dev)
    raw, kinds, args = pb.mix_inputs(dev, [(BLOOM_KIND, 0.0)] * B, seed=22)
    return {
        f'bloom u8 ({B}, {H}, {W}, 3)': (
            lambda: bl.bloom_batched(u8, params), BLOOM, 1),
        f'bloom f32 ({B}, {H}, {W}, 3)': (
            lambda: bl.bloom_batched(f32, params), BLOOM, 1),
        f'mix_noise, {B} bloom images': (
            lambda: mk.fused_mix_noise(raw, *args, kinds),
            ('mix_noise_kernel',), 1),
        f'mix_bilateral, {B} bloom images': (
            lambda: mk.fused_mix_bilateral(raw, *args, kinds),
            ('mix_bilateral_kernel',), 1)}


def profile(dev, iters: int = 20) -> dict:
    """{case: {ms, device_ms, output_sha256}} for every case."""
    out = {}
    # the poisson stage's long traces last: a trace after one has come
    # back short of launches on the card
    for case, (fn, symbols, per_call) in {**bloom_cases(dev),
                                          **threefry_cases(dev),
                                          **poisson_case(dev)}.items():
        sha = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        out[case] = t = dict(
            ms=time_ms(fn, iters),
            device_ms=device_ms(fn, iters, symbols, per_call=per_call),
            output_sha256=sha)
        print(f'{case}: {t["ms"]:.4f} ms (CUDA events), {t["device_ms"]} ms '
              f'(profiler device time of {"/".join(symbols)}), output '
              f'{sha}', flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_noise_kernels: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    print(json.dumps({'card': card, 'results': profile('cuda')}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
