"""Time the threefry draw kernel, the bloom kernel (kernel 8), kernels 1
and 4 (salt & pepper + median, batched and one image a launch), kernel 2
(gaussian + blur), kernels 6 and 7 (mixed noise, and mixed noise +
bilateral) and kernels 9-11 (salt & pepper + median cut into stages, on a
pre-padded raster) through the port's wrappers, at their paths' shapes, in
milliseconds by CUDA events (host time between the launches included) and
by torch.profiler device time (the kernels alone).

    python3 -m tpudenoise_torch.benchmarks.profile_noise_kernels \
        [--match S ...]

Cases:
  * `noise/bloom.py:bloom_batched` on (8, 600, 1000, 3) u8 and f32
    images with `bloom_params` params, and the bloom kind of the mix
    kernels 6 and 7 (`bloom_steps.cuh` is shared): 8 images that all draw
    bloom;
  * `noise/fused_kernels.py:fused_sap_median_batched` on (8, 600, 1000,
    3) u8 images and f32 images that are not integers, with one and with
    two medians; `fused_sap_median` on the f32 integer values of the same
    8 images, one launch each (kernel 4's entry path); where the library
    exports it (older trees do not), the u8 images through the float
    route (`sap_median_u8_float`), the yardstick of the packed route;
  * `noise/fused_kernels.py:fused_gaussian_blur` on (8, 600, 1000, 3)
    images with a noise std per image (the three levels, as
    chip_smoke.py's check draws them): u8 with noise, f32 with noise, f32
    without noise, each with one and with two blurs;
  * `noise/mix_kernels.py:fused_mix_noise` on 8 images of 600x1000 of
    each of the 13 kinds, at the kind's first level in
    `profile_bilateral.MIX_ENTRIES` (chip_smoke.py's per-kind inputs), and
    on 8 poisson images dark in their left half (both of poisson's
    samplers in one warp); `fused_mix_bilateral` on the 8 images of
    poisson, gamma, gaussian and original;
  * `noise/fused_kernels.py:sap_stages` at the profiling scripts' size
    (128 images of 600x1000, `STAGE_TILES`): every stage of the f32
    (kernel 9) and u8 (kernel 10) edge-padded rasters of the same random
    images, and `sap_full_padded` (kernel 11) on `profile_fused`'s random
    raster; where the library exports it (older trees do not), med1 and
    full of the f32 raster through the float walk alone
    (`sap_stages_f32_float`), the yardstick of the packed start;
  * `core/prng.py:threefry_draw` in its three modes for 8 keys x 1.8M
    words (one (8, 600, 1000, 3) field: the speckle draw is the normal
    one) and the uniform draw for 64 keys x 1.8M (poisson's PTRS rounds:
    8 images x 4 rounds x 2 fields);
  * the summed threefry device time of one poisson noise stage on 8
    images of 600x1000 (its three draws: 8, 8 and 64 keys), last: a trace
    after its long ones has come back short of launches on the card;
  * parity: no timing, one hash of every output of kernels 1, 2, 4, 6, 7
    and 9-11 on small and odd shapes (odd widths, H = 1 or 2 and W = 1 or
    2, B = 1, 8 and 9; u8 and f32 with and without noise, non-integer and
    wide-range f32 values, one and two medians or blurs; all 13 kinds, a
    dark-band poisson image and one with four distinct values; every
    stage on edge-padded and random rasters, f32 rasters of non-integers
    and with a few non-integer rows, and rows that are not 16-byte
    aligned).
Each case also prints a hash of the output, so that two versions of the
port, run one after the other on the same card, can be shown to give the
same bits.  --match S (repeatable) times only the cases whose names hold
one of the S, and hashes no parity outputs (`--match "kernels 9-11"`
picks kernels 9-11; "kernel 1" does not match them).  The script uses
only entry points that the port has had since its threefry kernel came:
to time an older tree, copy this file and `timing.py` into its
`tpudenoise_torch/benchmarks/` and run it there.  The last line is the
card's name and power limit; the one before it the results as JSON.
Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.benchmarks import profile_bilateral as pb
from tpudenoise_torch.benchmarks import profile_fused as pf
from tpudenoise_torch.benchmarks import profile_sap_breakdown as psb
from tpudenoise_torch.benchmarks.timing import card_line, device_ms, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import bloom as bl
from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise.generators import bloom_params
from tpudenoise_torch.noise.mix_prologue import fixed_prologue
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import Kind

B, H, W = 8, 600, 1000
N = H * W * 3
PTRS_KEYS = 64          # poisson's PTRS draw: B images x 4 rounds x 2
THREEFRY = ('threefry_kernel',)
BLOOM = ('bloom_kernel',)
BLOOM_KIND = 11         # Kind.BLOOM
SAP = ('sap_median_kernel',)
# kernels 9-11: the stage kernels' names begin so in every tree
STAGES = ('sap_stages_',)
STAGE_B = 128
# the tile heights the profiling scripts' rows are timed at
STAGE_TILES = {'sap_stages_f32': 56, 'sap_stages_u8': 120,
               'sap_full_padded': 56}
GAUSS = ('gauss_blur_kernel',)
MIX = ('mix_noise_kernel', 'brownian_')
MIX_BIL = ('mix_bilateral_kernel', 'brownian_')
POISSON, GAMMA = 2, 9
BILATERAL_KINDS = (POISSON, GAMMA, 1, 0)   # poisson, gamma, gaussian, original
LEVELS = np.sqrt(np.asarray([0.1, 1.0, 1.5], np.float32))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def gauss_inputs(dev, shape, seed):
    """(u8 images, f32 images, seeds, sigmas) for kernel 2."""
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    seeds = rng.randint(0, 2**31 - 1, shape[0]).astype(np.int32)
    sig = LEVELS[rng.randint(0, 3, shape[0])]
    u8 = torch.from_numpy(raw).to(dev)
    return (u8, u8.to(torch.float32), torch.from_numpy(seeds).to(dev),
            torch.from_numpy(sig).to(dev))


def mix_case(dev, h, w, entries, seed, dark=False, values=None):
    """(raw, kinds, args) for images i taking entries[i] = (kind, level);
    dark: the left half of every image below 8 (lam < 10 for poisson);
    values: the pixels drawn from these values only."""
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (len(entries), h, w, 3)).astype(np.uint8)
    if values is not None:
        raw = rng.choice(np.asarray(values, np.uint8), raw.shape)
    if dark:
        raw[:, :, :w // 2] //= 32
    raw = torch.from_numpy(raw).to(dev)
    kinds, *args = fixed_prologue(prng.split(prng.PRNGKey(seed),
                                             len(entries)), raw, entries)
    return raw, kinds, args


def sap_inputs(dev, shape, seed):
    """(u8 images, f32 non-integers, f32 values from 1e-2 to 1e9 of both
    signs, seeds) for kernels 1 and 4."""
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    frac = raw + rng.uniform(-0.5, 0.5, raw.shape).astype(np.float32)
    wide = (rng.choice([-1, 1], raw.shape)
            * 10.0 ** rng.uniform(-2, 9, raw.shape)).astype(np.float32)
    seeds = rng.randint(0, 2**31 - 1, shape[0]).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (raw, frac, wide, seeds))


def sap_u8_float(u8, seeds, double):
    """u8 images through kernel 1's float route (no wrapper calls it)."""
    out = torch.empty_like(u8)
    b, h, w, _ = u8.shape
    cuda_build.launch('fused_noise', 'sap_median_u8_float', u8, out, seeds,
                      b, h, 3 * w, fk._sap_threshold_i32(0.4), int(double))
    return out


def has_float_route() -> bool:
    return hasattr(cuda_build.library('fused_noise'), 'sap_median_u8_float')


def sap_cases(dev) -> dict:
    """{case: (fn, symbols, launches a call)} for kernels 1 and 4."""
    u8, frac, _, seeds = sap_inputs(dev, (B, H, W), 3)
    f32 = u8.to(torch.float32)
    cases = {}
    for double in (True, False):
        med = 'two medians' if double else 'one median'
        cases[f'kernel 1 u8, {med}'] = (
            lambda d=double: fk.fused_sap_median_batched(u8, seeds, 0.4, d),
            SAP, 1)
        cases[f'kernel 1 f32 non-integers, {med}'] = (
            lambda d=double: fk.fused_sap_median_batched(frac, seeds, 0.4,
                                                         d), SAP, 1)
        if has_float_route():
            cases[f'kernel 1 u8 through the float route, {med}'] = (
                lambda d=double: sap_u8_float(u8, seeds, d), SAP, 1)
    cases[f'kernel 4, {B} images, one launch each'] = (
        lambda: fk.fused_sap_median(f32, seeds, 0.4, True), SAP, B)
    return cases


def stages_f32_float(raster, seeds, h, w3, stage):
    """The f32 stages with med1 and full on the float walk alone (no
    wrapper calls it)."""
    b, rows, w3p = raster.shape
    out = torch.empty((b, rows - 2 * fk.HALO, w3p), dtype=raster.dtype,
                      device=raster.device)
    cuda_build.launch('sap_stages', 'sap_stages_f32_float', raster, out,
                      seeds, b, h, w3, rows - 2 * fk.HALO, w3p,
                      fk.STAGES.index(stage), fk._sap_threshold_i32(0.4))
    return out


def has_stage_float_walk() -> bool:
    return hasattr(cuda_build.library('sap_stages'), 'sap_stages_f32_float')


def stage_cases(dev) -> dict:
    """{case: (fn, symbols, launches a call)} for kernels 9-11 at B = 128:
    the rasters `profile_sap_breakdown.run` / `u8_run` and
    `profile_fused.kernel_only` hand their kernels."""
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (STAGE_B, H, W, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.arange(STAGE_B, dtype=torch.int32, device=dev)
    f32 = psb.pad_raster(images.to(torch.float32),
                         STAGE_TILES['sap_stages_f32'])
    u8 = psb.pad_raster(images, STAGE_TILES['sap_stages_u8'])
    del images
    padded, pseeds = pf.padded_raster(STAGE_TILES['sap_full_padded'], dev)
    float_walk = has_stage_float_walk()
    cases = {}
    for stage in fk.STAGES:
        cases[f'kernels 9-11, f32 {stage}, B={STAGE_B}'] = (
            lambda st=stage: fk.sap_stages(f32, seeds, H, 3 * W, st),
            STAGES, 1)
        cases[f'kernels 9-11, u8 {stage}, B={STAGE_B}'] = (
            lambda st=stage: fk.sap_stages(u8, seeds, H, 3 * W, st),
            STAGES, 1)
        if float_walk and stage in ('med1', 'full'):
            cases[f'kernels 9-11, f32 {stage} through the float walk, '
                  f'B={STAGE_B}'] = (
                lambda st=stage: stages_f32_float(f32, seeds, H, 3 * W, st),
                STAGES, 1)
    cases[f'kernels 9-11, kernel_only full, B={STAGE_B}'] = (
        lambda: fk.sap_full_padded(padded, pseeds, H, 3 * W, 0.4), STAGES, 1)
    return cases


def gauss_mix_cases(dev) -> dict:
    """{case: (fn, symbols, launches a call)} for kernels 2, 6 and 7."""
    u8, f32, seeds, sig = gauss_inputs(dev, (B, H, W), 3)
    cases = {}
    for double in (True, False):
        blurs = 'two blurs' if double else 'one blur'
        cases[f'kernel 2 u8 + noise, {blurs}'] = (
            lambda d=double: fk.fused_gaussian_blur(u8, seeds, 0.1, d,
                                                    sigmas=sig), GAUSS, 1)
        cases[f'kernel 2 f32 + noise, {blurs}'] = (
            lambda d=double: fk.fused_gaussian_blur(f32, seeds, 0.1, d,
                                                    sigmas=sig), GAUSS, 1)
        cases[f'kernel 2 f32 no noise, {blurs}'] = (
            lambda d=double: fk.fused_gaussian_blur(f32, seeds, 0.0, d),
            GAUSS, 1)
    per_kind = {kind: mix_case(dev, H, W, [(kind, level)] * B, 11 + kind)
                for kind, level in pb.MIX_ENTRIES[:13]}
    for kind, (raw, kk, args) in per_kind.items():
        name = Kind(kind).name.lower()
        cases[f'kernel 6, 8 {name} images'] = (
            lambda raw=raw, kk=kk, args=args: mk.fused_mix_noise(
                raw, *args, kk), MIX, 1)
    raw, kk, args = mix_case(dev, H, W, [(POISSON, 0.0)] * B, 40, dark=True)
    cases['kernel 6, 8 poisson images dark in their left half'] = (
        lambda raw=raw, kk=kk, args=args: mk.fused_mix_noise(raw, *args, kk),
        MIX, 1)
    for kind in BILATERAL_KINDS:
        raw, kk, args = per_kind[kind]
        cases[f'kernel 7, 8 {Kind(kind).name.lower()} images'] = (
            lambda raw=raw, kk=kk, args=args: mk.fused_mix_bilateral(
                raw, *args, kk), MIX_BIL, 1)
    return cases


SAP_SHAPES = [(1, 1, 1), (9, 1, 7), (1, 2, 2), (2, 3, 1), (9, 9, 2),
              (1, 17, 40), (9, 65, 40), (1, 57, 253), (1, 161, 253),
              (2, 601, 999)]
GAUSS_SHAPES = [(1, 2, 2), (1, 2, 7), (2, 3, 5), (3, 37, 29), (8, 37, 101),
                (1, 130, 333), (2, 601, 999)]
MIX_SHAPES = [(24, 40), (37, 71), (75, 290)]

# (B, h, w, tile height) of the stage kernels' parity: h <= 3, odd h, hp -
# h of several walk steps, w3 = 3, w3p of 128 and 3072
STAGE_SHAPES = [(2, 1, 5, 8), (1, 3, 1, 56), (2, 13, 40, 8),
                (1, 61, 301, 16), (2, 600, 1000, 56)]


def stage_parity(dev, b, h, w, tile_h) -> dict:
    """{case: hash} of every stage of kernels 9-11 on one shape: edge-padded
    u8 and f32 rasters, random ones (halo rows and pad lanes random), f32
    non-integers and integers with a few non-integer rows; and every
    stage on a raster whose rows are not 16-byte aligned."""
    rng = np.random.RandomState(b + h + w + tile_h)
    im = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, b).astype(
        np.int32)).to(dev)
    edge = psb.pad_raster(im, tile_h)
    hp = edge.shape[1] - 2 * fk.HALO
    rand = torch.from_numpy(rng.randint(0, 256, tuple(edge.shape))).to(dev)
    frac = rand.to(torch.float32) + torch.from_numpy(rng.uniform(
        -0.5, 0.5, tuple(edge.shape)).astype(np.float32)).to(dev)
    rows = rand.to(torch.float32)
    rows[:, rng.randint(hp // 2, hp + 2 * fk.HALO, 2), ::29] += 0.5
    n = b * (hp + 2 * fk.HALO) * (3 * w + 2)
    buf = torch.from_numpy(rng.randint(0, 256, n + 1)).to(dev)
    rasters = {'u8 edge': edge, 'f32 edge': edge.to(torch.float32),
               'u8 random': rand.to(torch.uint8),
               'f32 random': rand.to(torch.float32),
               'f32 non-integers': frac, 'f32 non-integer rows': rows,
               'u8 unaligned': buf.to(torch.uint8)[1:].view(
                   b, hp + 2 * fk.HALO, 3 * w + 2),
               'f32 unaligned': buf.to(torch.float32)[1:].view(
                   b, hp + 2 * fk.HALO, 3 * w + 2)}
    out = {}
    for name, r in rasters.items():
        for stage in fk.STAGES:
            out[f'kernels 9-11 {(b, h, w, tile_h)} {name} {stage}'] = sha(
                fk.sap_stages(r, seeds, h, 3 * w, stage))
    return out


def parity(dev) -> dict:
    """{case: hash} of kernels 1, 2, 4, 6 and 7 on small and odd shapes."""
    out = {}
    for shape in SAP_SHAPES:
        u8, frac, wide, seeds = sap_inputs(dev, shape, sum(shape))
        for double in (True, False):
            for name, im in (('u8', u8), ('f32', u8.to(torch.float32)),
                             ('f32 non-integers', frac),
                             ('f32 wide range', wide)):
                out[f'kernel 1 {shape} {name} double={double}'] = sha(
                    fk.fused_sap_median_batched(im, seeds, 0.4, double))
                if im.dtype == torch.float32:
                    out[f'kernel 4 {shape} {name} double={double}'] = sha(
                        fk.fused_sap_median(im, seeds, 0.4, double))
    for shape in GAUSS_SHAPES:
        u8, f32, seeds, sig = gauss_inputs(dev, shape, sum(shape))
        rng = np.random.RandomState(shape[1])
        frac = f32 + torch.from_numpy(rng.uniform(
            -0.5, 0.5, f32.shape).astype(np.float32)).to(dev)
        wide = torch.from_numpy((rng.choice([-1, 1], f32.shape) * 10.0 ** rng
                                 .uniform(-2, 9, f32.shape)).astype(
                                     np.float32)).to(dev)
        for double in (True, False):
            runs = {'u8 + noise': (u8, 0.1, sig), 'u8': (u8, 0.0, None),
                    'u8 var 1.5': (u8, 1.5, None),
                    'f32 + noise': (f32, 0.1, sig), 'f32': (f32, 0.0, None),
                    'f32 non-integers': (frac, 0.0, None),
                    'f32 wide range': (wide, 0.0, None),
                    'f32 non-integers + noise': (frac, 0.1, sig)}
            for name, (im, var, sg) in runs.items():
                got = fk.fused_gaussian_blur(im, seeds, var, double,
                                             sigmas=sg)
                out[f'kernel 2 {shape} {name} double={double}'] = sha(got)
    for b, h, w, tile_h in STAGE_SHAPES:
        out.update(stage_parity(dev, b, h, w, tile_h))
    entries = list(pb.MIX_ENTRIES)
    for h, w in MIX_SHAPES:
        cases = {'all kinds': mix_case(dev, h, w, entries, h * w),
                 'poisson dark half': mix_case(
                     dev, h, w, [(POISSON, 0.0)] * 2, h + w, dark=True),
                 'poisson vals 4': mix_case(
                     dev, h, w, [(POISSON, 0.0)] * 2, h, values=(0, 90, 170,
                                                                255)),
                 'gamma': mix_case(dev, h, w, [(GAMMA, 0.2), (GAMMA, 1.0)],
                                   w)}
        for name, (raw, kk, args) in cases.items():
            for kernel, fn in (('6', mk.fused_mix_noise),
                               ('7', mk.fused_mix_bilateral)):
                out[f'kernel {kernel} ({h}, {w}) {name}'] = sha(
                    fn(raw, *args, kk))
    return out


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


def profile(dev, iters: int = 20, match: list | None = None) -> dict:
    """{'results': {case: {ms, device_ms, output_sha256}}, 'parity': {case:
    hash}, 'parity_hash': hash of the parity hashes}; with `match`, only
    the cases whose names hold one of its strings, and no parity."""
    out = {}
    groups = (bloom_cases, sap_cases, gauss_mix_cases, stage_cases,
              threefry_cases, poisson_case)
    cases = {k: v for g in groups for k, v in g(dev).items()
             if match is None or any(m in k for m in match)}
    for case, (fn, symbols, per_call) in cases.items():
        digest = sha(fn())
        out[case] = t = dict(
            ms=time_ms(fn, iters),
            device_ms=device_ms(fn, iters, symbols, per_call=per_call),
            output_sha256=digest)
        print(f'{case}: {t["ms"]:.4f} ms (CUDA events), {t["device_ms"]} ms '
              f'(profiler device time of {"/".join(symbols)}), output '
              f'{digest}', flush=True)
    if match:
        return {'results': out}
    par = parity(dev)
    digest = hashlib.sha256(json.dumps(par, sort_keys=True).encode()
                            ).hexdigest()[:16]
    print(f'parity: {len(par)} outputs, hash of their hashes {digest}',
          flush=True)
    return {'results': out, 'parity': par, 'parity_hash': digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--match', action='append',
                    help='time only the cases whose names hold this '
                    '(repeatable); no parity hashes')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_noise_kernels: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    print(json.dumps({'card': card, **profile('cuda', match=args.match)}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
