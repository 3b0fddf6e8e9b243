"""Drive the PyTorch/CUDA port's eval chunk on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without a GPU):
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off;
  2. build: nvcc builds the seven kernel sources of tpudenoise_torch/csrc
     (twelve kernels), one nvcc process each, all at once;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes, each timed beside its plain version:
     sap+median (8, 600, 1000, 3) u8 bit-exact; gaussian+blur same shape
     within max |diff| <= 1 on <= 1e-3 of the pixels; packed NMS masks
     8 x 6144 sorted boxes word for word; mix noise and mix + bilateral on
     16 images of 600x1000 whose explicit branches cover all 13 kinds
     (levels from the var_all table; quant palettes and bloom params from
     the port's prologue), bit-exact for original, sap, shader, quant,
     bloom, periodic and brownian, and within a mod-256 distance of 1 on
     <= 1e-3 of the elements for the kinds that go through log/exp/cos
     (gaussian's [0, 1] floats within 1e-6); bloom on 8 images bit-exact;
     the standalone bilateral (8, 600, 1000, 3) f32 bit-exact; the
     per-image sap + median entry on the same shape bit-exact; the
     threefry fields for 8 keys x 1.8M elements: bits and uniforms
     bit-exact, normals within 2 ulp; the stage-cut sap + median kernels
     (the profiling forks) on the edge-padded raster of (8, 600, 1000, 3)
     f32 and u8 images, every stage, and the full stage on a random
     raster, bit-exact, and again at the profiling scripts' size (B=128),
     where each is timed;
  4. correctness of the whole chunk on a small input: the card's
     detect_chunk (f32) against the same chunk run on the CPU through the
     plain versions, for sap, gauss, noise_mix_var_all_bilateral,
     speckle_bilateral_var1.0, uniform_mean_var0.6 and quant_var10, and
     the sap chunk with a seeded res50;
  5. main path: detect_chunk with a seeded-init vgg16 VOC-21 Faster R-CNN
     in bf16 on (8, 600, 1000, 3) u8 frames, bucket (608, 1024), for
     sap_median_var0.4, gaussian_gaus_blur_var0.1,
     noise_mix_var_all_bilateral, noise_mix_var_all, bloom,
     speckle_bilateral_var1.0 and poisson; 3 warm + 5 timed chunks each,
     chunk i holding images 8i..8i+7 (so each chunk draws its own noise
     and, for the mixes, its own kinds); the launch counters are zeroed
     before each path and read after it, and the path's kernels must have
     launched; then the per-image sap + median entry's own path on the
     sap chunk's images and seeds, equal to the batched kernel's result;
     then the same chunk with a seeded-init ResNet-101 (bench_config6's
     model) for sap_median_var0.4; then the profiling path: the two
     profiling entry points (`profile_sap_breakdown.run` / `u8_run` and
     `profile_fused.kernel_only_output`) once each at B=128, each equal
     to its plain version;
  6. where the time goes: two chunks of each string under torch.profiler
     (device kernel time, idle share, the port's own kernels' share), and
     of the res101 sap chunk.
Each kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over 67 T/s (the card's non-tensor f32
rate; integer and transcendental operations counted one each, from the
plain version's per-element operations).  The line before the last is
the card's name and power limit, the one before that the kernel table as
JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.benchmarks import profile_fused as pf
from tpudenoise_torch.benchmarks import profile_sap_breakdown as psb
from tpudenoise_torch.benchmarks.timing import card_line, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.denoise import bilateral as bil
from tpudenoise_torch.eval.harness import (detect_chunk, limit_per_image,
                                           set_matmul_precision)
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.noise import bloom as bl
from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise.generators import bloom_apply_scan, bloom_params
from tpudenoise_torch.noise.mix_prologue import (entry_draws, fixed_prologue,
                                                 plan_tables)
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import Kind, parse
from tpudenoise_torch.ops import nms

B, H, W = 8, 600, 1000
BUCKET = (608, 1024)
NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
          'noise_mix_var_all_bilateral', 'noise_mix_var_all', 'bloom',
          'speckle_bilateral_var1.0', 'poisson')
SMALL_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
                'noise_mix_var_all_bilateral', 'speckle_bilateral_var1.0',
                'uniform_mean_var0.6', 'quant_var10')
SOURCES = ('fused_noise', 'nms_mask', 'mix_noise', 'bloom', 'bilateral',
           'threefry', 'sap_stages')
# the res101 main path: bench_config6's model and noise
RES_NOISES = ('sap_median_var0.4',)
# the profiling scripts' batch and the tile heights their rows are timed at
PROFILE_B = 128
PROFILE_TILES = {'sap_stages_f32': 56, 'sap_stages_u8': 120,
                 'sap_full_padded': 56}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
# operations per element (one of B*H*W*3), counted from each plain
# version, a transcendental as one: hash 15, compare/select 4, a 3x3
# median pass 16, a [1,2,1] blur pass 12, Box-Muller 12, the 49-tap
# bilateral 312 (937 per pixel), a 48-step bloom composite 430, a
# threefry word 78 (+4 for a uniform, +22 for erf_inv)
OPS = {'sap_median': 15 + 4 + 2 * 16, 'gauss_blur': 2 * 15 + 12 + 6 + 2 * 12,
       'bilateral': 312, 'bloom': 430, 'bits': 78, 'uniform': 82,
       'normal': 104}
# the stage-cut sap + median kernel, per output element
STAGE_OPS = {'copy': 0, 'noise': 15 + 4, 'med1': 15 + 4 + 16,
             'full': OPS['sap_median']}
# mix kernels, by kind (Kind value): the kind's generator per element
MIX_OPS = {0: 0, 1: 45, 2: 330, 3: 20, 4: 47, 5: 110, 6: 22, 7: 60, 8: 8,
           9: 300, 10: 25, 11: 430, 12: 6}
# one image per kind, levels from the var_all table, then brownian,
# periodic and quant at a second level: (Kind value, level)
MIX_ENTRIES = [(0, 0.0), (1, 1.0), (2, 0.0), (3, 0.8), (4, 2.0), (5, 7.0),
               (6, 1.2), (7, 0.9), (8, 100.0), (9, 0.2), (10, 0.3),
               (11, 0.0), (12, 0.0), (7, 0.009), (8, -1.0), (5, 10.0)]
# kinds through logf/expf/cosf: gaussian, poisson, speckle, uniform,
# gamma, rayleigh (their bound is stated; the rest must be bit-exact)
TRANSCENDENTAL = {1, 2, 4, 6, 9, 10}


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the non-tensor rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                # no single PyTorch call computes any of these functions
                library_ms=None)


def near_threshold_pairs(rng, k: int, t: float = 0.7):
    """k box pairs (A, A shifted right by dx) whose f32 IoU, evaluated in
    the reference's operation order, lies at or one ulp beside f32(t):
    dx is nudged by f32 ulps onto the boundary, then a third of the pairs
    step one ulp left and a third one ulp right.  Returns two (k, 4)
    arrays."""
    f, t32 = np.float32, np.float32(t)
    x, y = rng.uniform(0, 300, (2, k)).astype(f)
    w, h = rng.uniform(20, 200, (2, k)).astype(f)
    a = np.stack([x, y, x + w, y + h], 1)

    def shifted(dx):
        return np.stack([x + dx, y, x + dx + w, y + h], 1)

    def iou(b):
        ba = (a[:, 2] - a[:, 0] + f(1)) * (a[:, 3] - a[:, 1] + f(1))
        area = (b[:, 2] - b[:, 0] + f(1)) * (b[:, 3] - b[:, 1] + f(1))
        iw = np.maximum(f(0), np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]) + f(1))
        ih = np.maximum(f(0), np.minimum(a[:, 3], b[:, 3])
                        - np.maximum(a[:, 1], b[:, 1]) + f(1))
        inter = iw * ih
        return inter / ((ba + area) - inter)

    dx = ((w + 1) * f((1 - t) / (1 + t))).astype(f)
    for _ in range(64):
        v = iou(shifted(dx))
        dx = np.where(v == t32, dx, np.nextafter(
            dx, np.where(v > t32, f(np.inf), f(-np.inf)))).astype(f)
    step = rng.randint(-1, 2, k)
    dx = np.where(step == 0, dx, np.nextafter(
        dx, np.where(step > 0, f(np.inf), f(-np.inf)))).astype(f)
    return a, shifted(dx)


def nms_boxes(rng, b: int, n: int) -> np.ndarray:
    """(b, n, 4) score-sorted proposal-like boxes with exact duplicates,
    pairs at IoU exactly 0.7 (a 10x10 box and its 10x7 top part) and
    pairs within an f32 ulp of IoU 0.7 (any change to the order of the
    IoU arithmetic flips some of their bits)."""
    out = np.empty((b, n, 4), np.float32)
    for i in range(b):
        xy = rng.uniform(0, [W - 32, H - 32], (n, 2))
        wh = rng.uniform(8, 300, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], 1)
        dup = rng.choice(n, n // 8, replace=False)
        boxes[dup[1:]] = boxes[dup[:-1]]
        for k in rng.choice(n - 1, n // 16, replace=False):
            x, y = np.floor(rng.uniform(0, 900, 2))
            boxes[k] = (x, y, x + 9, y + 9)
            boxes[k + 1] = (x, y, x + 9, y + 6)
        a, c = near_threshold_pairs(rng, n // 16)
        boxes[n // 2::8], boxes[n // 2 + 1::8] = a, c
        out[i] = boxes
    return out


def check_kernels(dev) -> list:
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.from_numpy(rng.randint(0, 2**31 - 1, B).astype(
        np.int32)).to(dev)
    rows = []

    # kernel 1: bit-exact
    got = fk.fused_sap_median_batched(raw, seeds, 0.4, True)
    want = fk.fused_sap_median_plain(raw, seeds, 0.4, True)
    torch.cuda.synchronize()
    err = (got.int() - want.int()).abs().max().item()
    log(f'kernel sap_median: max |diff| {err} (bit-exact required)')
    if err != 0:
        raise AssertionError('sap_median kernel differs from its plain '
                             'version')
    rows.append(dict(
        name='fused_sap_median_batched', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:389',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median_batched(raw, seeds, 0.4,
                                                       True), 20),
        plain_ms=time_ms(lambda: fk.fused_sap_median_plain(raw, seeds, 0.4,
                                                           True), 3, 1),
        **bound(2 * raw.numel(), OPS['sap_median'] * raw.numel())))

    # kernel 2: per-image sigma from the three levels
    lv = np.sqrt(np.asarray([0.1, 1.0, 1.5], np.float32))
    sig = torch.from_numpy(lv[rng.randint(0, 3, B)]).to(dev)
    got = fk.fused_gaussian_blur(raw, seeds, 0.1, True, sigmas=sig)
    want = fk.fused_gaussian_blur_plain(raw, seeds, 0.1, True, sigmas=sig)
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    err = diff.max().item()
    share = (diff.amax(-1) > 0).double().mean().item()
    log(f'kernel gauss_blur: max |diff| {err}, changed pixel share '
        f'{share:.3e} (bound: max 1, share 1e-3)')
    if err > 1 or share > 1e-3:
        raise AssertionError('gauss_blur kernel outside its bound')
    rows.append(dict(
        name='fused_gaussian_blur', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:192',
        max_abs_err=float(err), changed_share=share,
        ms=time_ms(lambda: fk.fused_gaussian_blur(raw, seeds, 0.1, True,
                                                  sigmas=sig), 20),
        plain_ms=time_ms(lambda: fk.fused_gaussian_blur_plain(
            raw, seeds, 0.1, True, sigmas=sig), 3, 1),
        **bound(2 * raw.numel(), OPS['gauss_blur'] * raw.numel())))

    # kernel 3: word for word at the TEST budget (6000 -> 6144)
    boxes = torch.from_numpy(nms_boxes(rng, B, 6144)).to(dev)
    got = nms.build_suppression_masks_cuda(boxes, 0.7)
    want = nms.build_suppression_masks(boxes, 0.7)
    torch.cuda.synchronize()
    bad = (got != want).sum().item()
    err = (got.long() - want.long()).abs().max().item()
    log(f'kernel suppression_masks: {bad} of {got.numel()} words differ; '
        f'{int((got != 0).sum())} non-zero words')
    if bad or not got.any():
        raise AssertionError('suppression mask kernel differs from its '
                             'plain version')
    rows.append(dict(
        name='build_suppression_masks_cuda', route='cuda',
        source='tpudenoise_torch/csrc/nms_mask.cu',
        replaces='tpudenoise/ops/nms.py:234', max_abs_err=float(err),
        ms=time_ms(lambda: nms.build_suppression_masks_cuda(boxes, 0.7), 20),
        plain_ms=time_ms(lambda: nms.build_suppression_masks(boxes, 0.7),
                         3, 1),
        # 512 x 512 tiles on or above the diagonal, ~15 operations per
        # pair; the boxes read, the words written
        **bound(boxes.numel() * 4 + got.numel() * 4,
                15 * B * 512 * 512 * (lambda t: t * (t + 1) // 2)(
                    -(-boxes.shape[1] // 512)))))

    # kernel 4: the per-image entry of kernel 1 (f32 I/O), bit-exact
    img = raw.to(torch.float32)
    got = fk.fused_sap_median(img, seeds, 0.4, True)
    torch.cuda.synchronize()
    err = (got - fk.fused_sap_median_plain(img, seeds, 0.4, True)).abs(
    ).max().item()
    log(f'kernel sap_median (per image): max |diff| {err} (bit-exact '
        f'required)')
    if err != 0:
        raise AssertionError('per-image sap_median differs from its plain '
                             'version')
    rows.append(dict(
        name='fused_sap_median', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:339',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median(img, seeds, 0.4, True), 20),
        plain_ms=time_ms(lambda: fk.fused_sap_median_plain(img, seeds, 0.4,
                                                           True), 3, 1),
        **bound(8 * img.numel(), OPS['sap_median'] * img.numel())))

    # kernel 5: the standalone bilateral, bit-exact, on u8-domain floats
    # with a zero band (as clipped noise makes)
    img[:, :, :7] = 0.0
    got = bil.bilateral_batched(img)
    torch.cuda.synchronize()
    err = (got - bil.bilateral_plain(img)).abs().max().item()
    log(f'kernel bilateral: max |diff| {err} (bit-exact required)')
    if err != 0:
        raise AssertionError('bilateral kernel differs from its plain '
                             'version')
    rows.append(dict(
        name='bilateral_batched', route='cuda',
        source='tpudenoise_torch/csrc/bilateral.cu',
        replaces='tpudenoise/denoise/pallas_bilateral.py:138',
        max_abs_err=float(err),
        ms=time_ms(lambda: bil.bilateral_batched(img), 20),
        plain_ms=time_ms(lambda: bil.bilateral_plain(img), 3, 1),
        **bound(8 * img.numel(), OPS['bilateral'] * img.numel())))
    return rows


def check_threefry(dev) -> list:
    """The threefry fields of the main path (8 keys x 1.8M elements)
    against the plain version on the card: bits and uniforms bit-exact,
    normals within 2 ulp; timed as the speckle draw (normals)."""
    n = H * W * 3
    keys = torch.from_numpy(prng.split(prng.PRNGKey(11), B).astype(
        np.int64)).to(dev)
    worst = 0
    for mode, lo, span in (('bits', 0.0, 1.0), ('uniform', 0.0, 1.0),
                           ('normal', 0.0, 1.0)):
        scale = float(prng._SQRT2)
        got = prng.threefry_draw(keys, n, mode, lo, span, scale)
        want = prng.threefry_draw_plain(keys, n, mode, lo, span, scale)
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs()
        m = ulp.max().item()
        log(f'kernel threefry {mode}: max {m} ulp, '
            f'{(ulp > 0).double().mean().item():.2e} differ (bound: 0 for '
            f'bits and uniforms, 2 ulp for normals)')
        if m > (2 if mode == 'normal' else 0):
            raise AssertionError(f'threefry {mode} outside its bound')
        worst = max(worst, (got - want).abs().max().item()
                    if mode == 'normal' else 0.0)
    bits_cpu = prng.threefry_draw(keys[:1].cpu(), 4096, 'bits')
    if not torch.equal(bits_cpu, prng.threefry_draw(keys[:1], 4096,
                                                    'bits').cpu()):
        raise AssertionError('threefry bits differ between card and CPU')
    draw = (lambda: prng.threefry_draw(keys, n, 'normal', 0.0, 1.0,
                                       float(prng._SQRT2)))
    return [dict(
        name='threefry_draw', route='cuda',
        source='tpudenoise_torch/csrc/threefry.cu',
        replaces='tpudenoise/noise/generators.py:140',
        max_abs_err=worst, ms=time_ms(draw, 20),
        plain_ms=time_ms(lambda: prng.threefry_draw_plain(
            keys, n, 'normal', 0.0, 1.0, float(prng._SQRT2)), 3, 1),
        **bound(4 * B * n, OPS['normal'] * B * n))]


def check_sap_stages(dev) -> list:
    """Kernels 9-11, the stage-cut forks of kernel 1, against their plain
    versions at (8, 600, 1000, 3), bit-exact: every stage on the
    edge-padded raster of f32 and u8 images (its full stage, sliced, must
    also equal kernel 1), and the full stage of `sap_full_padded` on a
    random raster whose halo rows and pad lanes hold arbitrary values.
    Then each stage is held bit-exact again and timed at the profiling
    scripts' size (B = 128, the row's tile height); the row's own numbers
    are the full stage's, and the copy stage has one PyTorch call, a
    slice's clone."""
    rng = np.random.RandomState(9)
    w3 = 3 * W
    seeds = torch.from_numpy(rng.randint(0, 2**31 - 1, B).astype(
        np.int32)).to(dev)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    big_raw = torch.from_numpy(rng.randint(0, 256, (PROFILE_B, H, W, 3))
                               .astype(np.uint8)).to(dev)
    big_seeds = torch.arange(PROFILE_B, dtype=torch.int32, device=dev)
    rows = []
    for name, dtype, line in (
            ('sap_stages_f32', torch.float32,
             'benchmarks/profile_sap_breakdown.py:105'),
            ('sap_stages_u8', torch.uint8,
             'benchmarks/profile_sap_breakdown.py:189'),
            ('sap_full_padded', torch.float32,
             'benchmarks/profile_fused.py:48')):
        tile_h = PROFILE_TILES[name]
        _, w3p, hp = psb.raster_geometry(H, W, tile_h)
        if name == 'sap_full_padded':
            small = torch.from_numpy(rng.randint(
                0, 256, (B, hp + 2 * fk.HALO, w3p)).astype(np.float32)
            ).to(dev)
            big = torch.from_numpy(rng.randint(
                0, 256, (PROFILE_B, hp + 2 * fk.HALO, w3p)).astype(
                    np.float32)).to(dev)
            stages = ('full',)

            def run(r, s, stage):
                return fk.sap_full_padded(r, s, H, w3, 0.4)
        else:
            small = psb.pad_raster(raw.to(dtype), tile_h)
            big = psb.pad_raster(big_raw.to(dtype), tile_h)
            stages = fk.STAGES

            def run(r, s, stage):
                return fk.sap_stages(r, s, H, w3, stage)
        err = 0.0
        for stage in stages:
            got = run(small, seeds, stage)
            want = fk.sap_stages_plain(small, seeds, H, w3, stage)
            torch.cuda.synchronize()
            bad = (got != want).sum().item()
            err = max(err, (got.float() - want.float()).abs().max().item())
            log(f'kernel {name} {stage}: {bad} of {got.numel()} elements '
                f'differ (bit-exact required)')
            if bad:
                raise AssertionError(f'{name} {stage} differs from its plain '
                                     f'version')
            if stage == 'full' and name != 'sap_full_padded':
                eval_noise = fk.fused_sap_median_batched(raw.to(dtype), seeds,
                                                         0.4, True)
                if not torch.equal(got[:, :H, :w3].reshape(B, H, W, 3),
                                   eval_noise):
                    raise AssertionError(f'{name} full differs from the '
                                         f'eval noise kernel')
        per_stage = {}
        for stage in stages:
            # at the profiling path's own shape too, bit-exact
            out = run(big, big_seeds, stage)
            if not torch.equal(out, fk.sap_stages_plain(big, big_seeds, H,
                                                        w3, stage)):
                raise AssertionError(f'{name} {stage} differs from its plain '
                                     f'version at B={PROFILE_B}')
            log(f'kernel {name} {stage} at B={PROFILE_B}: equal to its plain '
                f'version')
            per_stage[stage] = dict(
                ms=time_ms(lambda: run(big, big_seeds, stage), 20),
                plain_ms=time_ms(lambda: fk.sap_stages_plain(
                    big, big_seeds, H, w3, stage), 2, 1),
                # the raster read once, the output written once
                **bound((big.numel() + out.numel()) * big.element_size(),
                        STAGE_OPS[stage] * out.numel()))
            del out
        if 'copy' in per_stage:
            per_stage['copy']['library_ms'] = time_ms(
                lambda: big[:, fk.HALO:fk.HALO + hp].clone(), 20)
        del big, small
        rows.append(dict(
            name=name, route='cuda',
            source='tpudenoise_torch/csrc/sap_stages.cu', replaces=line,
            max_abs_err=err, batch=PROFILE_B, tile_h=tile_h,
            stages=per_stage, **per_stage['full']))
    return rows


def _mix_errors(got, want):
    """Per-entry (max distance, changed share) of kernel against plain:
    mod-256 distance for the wrapped kinds, absolute for gaussian's
    floats (scaled by 1e6, so the bound reads 1 for both)."""
    out = []
    for i, (kind, _) in enumerate(MIX_ENTRIES):
        d = (got[i] - want[i]).abs()
        if kind in TRANSCENDENTAL:
            d = d * 1e6 if kind == 1 else torch.minimum(d, 256.0 - d)
        out.append((kind, d.max().item(), (d > 0).double().mean().item()))
    return out


def check_mix_kernels(dev) -> list:
    """Kernels 6-8 at full width against their plain versions."""
    rng = np.random.RandomState(5)
    n = len(MIX_ENTRIES)
    raw = torch.from_numpy(rng.randint(0, 256, (n, H, W, 3)).astype(
        np.uint8)).to(dev)
    keys = prng.split(prng.PRNGKey(5), n)
    kinds, *args = fixed_prologue(keys, raw, MIX_ENTRIES)
    rows = []
    for name, fn, plain, line in (
            ('fused_mix_noise', mk.fused_mix_noise, mk.fused_mix_noise_plain,
             'tpudenoise/noise/pallas_mix.py:521'),
            ('fused_mix_bilateral', mk.fused_mix_bilateral,
             mk.fused_mix_bilateral_plain,
             'tpudenoise/noise/pallas_mix.py:598')):
        got = fn(raw, *args, kinds)
        torch.cuda.synchronize()
        want = plain(raw, *args, kinds)
        errs = _mix_errors(got, want)
        log(f'kernel {name}: (kind, max dist, changed share) '
            + ' '.join(f'({k}, {m:g}, {s:.2e})' for k, m, s in errs)
            + ' (bound: 0 for kinds 0,3,5,7,8,11,12; dist 1 on 1e-3 for '
            'kinds 1,2,4,6,9,10)')
        for kind, m, share in errs:
            if (m > 0 if kind not in TRANSCENDENTAL
                    else m > 1 or share > 1e-3):
                raise AssertionError(f'{name}: kind {kind} outside its '
                                     f'bound ({m}, {share})')
        rows.append(dict(
            name=name, route='cuda',
            source='tpudenoise_torch/csrc/mix_noise.cu', replaces=line,
            max_abs_err=(got - want).abs().max().item(),
            ms=time_ms(lambda: fn(raw, *args, kinds), 10),
            plain_ms=time_ms(lambda: plain(raw, *args, kinds), 2, 1),
            **bound(5 * raw.numel(), H * W * 3 * sum(
                MIX_OPS[k] + (OPS['bilateral'] if 'bilateral' in name
                              else 0) for k, _ in MIX_ENTRIES))))

    img = raw[:B]
    params = torch.from_numpy(bloom_params(prng.split(prng.PRNGKey(6), B),
                                           H, W)).to(dev)
    got = bl.bloom_batched(img, params)
    torch.cuda.synchronize()
    err = (got - bloom_apply_scan(img, params)).abs().max().item()
    log(f'kernel bloom: max |diff| {err} (bit-exact required)')
    if err != 0:
        raise AssertionError('bloom kernel differs from its plain version')
    rows.append(dict(
        name='bloom_batched', route='cuda',
        source='tpudenoise_torch/csrc/bloom.cu',
        replaces='tpudenoise/noise/pallas_bloom.py:29', max_abs_err=err,
        ms=time_ms(lambda: bl.bloom_batched(img, params), 20),
        plain_ms=time_ms(lambda: bloom_apply_scan(img, params), 3, 1),
        **bound(5 * img.numel(), OPS['bloom'] * img.numel())))
    return rows


def _dets(boxes, scores, mask, i, c):
    """(K, 5) kept detections of image i, class c."""
    m = mask[i, c]
    return np.hstack([boxes[i, c][m], scores[i, c][m][:, None]])


def check_small_chunk(dev):
    """The chunk on the card (f32) against the same chunk on the CPU:
    vgg16 for every small string, res50 for sap."""
    rng = np.random.RandomState(4)
    raw = torch.from_numpy(rng.randint(0, 256, (2, 120, 200, 3)).astype(
        np.uint8))
    geom = torch.tensor([[120, 200, 120, 200, 1.0]] * 2)
    bucket = (128, 224)
    res = {}
    for backbone, noises in (('vgg16', SMALL_NOISES),
                             ('res50', ('sap_median_var0.4',))):
        model = FasterRCNN(backbone, num_classes=21, cfg=default_config(),
                           dtype=torch.float32)
        params = model.init(torch.Generator().manual_seed(0))
        for d in ('cpu', dev):
            model.to(d)
            p = {k: v.to(d) for k, v in params.items()}
            for noise in noises:
                out = detect_chunk(model, p, prng.PRNGKey(3), [0, 1],
                                   raw.to(d), geom.to(d), geom[:, 2:].to(d),
                                   make_pipeline(noise), bucket)
                res[d, f'{backbone} {noise}'] = [t.cpu().numpy()
                                                 for t in out]
    for noise in sorted({n for _, n in res}):
        (cb, cs, cm), (gb, gs, gm) = res['cpu', noise], res[dev, noise]
        matched = total = 0
        for i in range(2):
            for c in range(cb.shape[1]):
                a = _dets(cb, cs, cm, i, c)
                g = _dets(gb, gs, gm, i, c)
                if abs(len(a) - len(g)) > 1:
                    raise AssertionError(f'{noise}: detection counts differ '
                                         f'({len(a)} vs {len(g)})')
                for row in a:
                    total += 1
                    matched += bool(g.size and
                                    np.abs(g - row).max(1).min() < 0.5)
        log(f'small chunk {noise}: {matched}/{total} CPU detections have a '
            f'card twin within 0.5 px')
        if total == 0 or matched / total < 0.95:
            raise AssertionError(f'{noise}: card and CPU chunks disagree')


COUNTERS = (fk.launches, nms.launches, mk.launches, bl.launches,
            bil.launches, prng.launches)
MASKS = 'build_suppression_masks_cuda'
# the kernels each main path must launch
PATH_KERNELS = {'sap_median_var0.4': ('fused_sap_median_batched', MASKS),
                'gaussian_gaus_blur_var0.1': ('fused_gaussian_blur', MASKS),
                'noise_mix_var_all_bilateral': ('fused_mix_bilateral', MASKS),
                'noise_mix_var_all': ('fused_mix_noise', MASKS),
                'bloom': ('bloom_batched', MASKS),
                'speckle_bilateral_var1.0': ('threefry_draw',
                                             'bilateral_batched', MASKS),
                'poisson': ('threefry_draw', MASKS)}
ENTRY_PATH = 'fused_sap_median entry'
PROFILE_PATH = 'profiling entry points'


def zero_counts():
    for counter in COUNTERS:
        for k in counter:
            counter[k] = 0


def launch_counts() -> dict:
    return {'fused_sap_median_batched': fk.launches['sap_median'],
            'fused_gaussian_blur': fk.launches['gauss_blur'],
            'fused_sap_median': fk.launches['sap_median_image'],
            MASKS: nms.launches['suppression_masks'],
            'fused_mix_noise': mk.launches['mix_noise'],
            'fused_mix_bilateral': mk.launches['mix_bilateral'],
            'bloom_batched': bl.launches['bloom'],
            'bilateral_batched': bil.launches['bilateral'],
            'threefry_draw': prng.launches['threefry'],
            'sap_stages_f32': fk.launches['sap_stages_f32'],
            'sap_stages_u8': fk.launches['sap_stages_u8'],
            'sap_full_padded': fk.launches['sap_full_padded']}


def kinds_drawn(noise: str, key, idx) -> dict:
    """How many of the images idx draw each kind of a mixed plan."""
    plan = parse(noise)
    if len(plan.specs) < 2:
        return {}
    kinds, eb, el = plan_tables(plan.specs)
    keys = prng.split(prng.fold_in(key, np.asarray(idx)), 1)[:, 0]
    pos = entry_draws(keys, eb, el)[0]
    names = [Kind(kinds[p]).name.lower() for p in pos]
    return {n: names.count(n) for n in sorted(set(names))}


def chunk_inputs(dev, backbone: str):
    """A main path's model (seeded VOC-21 Faster R-CNN, bf16), its params,
    the (8, 600, 1000, 3) u8 frames, their geometry and the eval key."""
    cfg = default_config()
    model = FasterRCNN(backbone, num_classes=21, cfg=cfg)
    params = model.init(torch.Generator().manual_seed(0))
    model.to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=dev)
    return model, params, raw, geom, geom[:, 2:].contiguous(), prng.PRNGKey(
        cfg.RNG_SEED)


def main_path(inputs, card: str, noises, tag: str = '') -> dict:
    """detect_chunk for each noise string: 3 warm and 5 timed chunks, the
    launch counters zeroed before and read after; results keyed
    `tag + noise`."""
    model, params, raw, geom, infos, key = inputs
    stages = ('noise', 'prep', 'forward', 'postprocess')
    result = {}
    for noise in noises:
        noise_fn = make_pipeline(noise)
        walls, per_stage = [], {s: [] for s in stages}
        zero_counts()
        for it in range(8):
            # chunk `it` holds images 8*it .. 8*it+7, so each chunk draws
            # its own noise (and, for the mixes, its own kinds)
            idx = list(range(B * it, B * it + B))
            events = [torch.cuda.Event(enable_timing=True)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events[0].record()

            def mark(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            boxes, scores, mask = detect_chunk(model, params, key, idx, raw,
                                               geom, infos, noise_fn, BUCKET,
                                               on_stage=mark)
            torch.cuda.synchronize()
            if it >= 3:
                walls.append(time.perf_counter() - t0)
                for s, a, b in zip(stages, events, events[1:]):
                    per_stage[s].append(a.elapsed_time(b))
        counts = launch_counts()
        missing = [k for k in PATH_KERNELS[noise] if not counts[k]]
        if missing:
            raise AssertionError(f'{noise}: the main path did not launch '
                                 f'{missing} ({counts})')
        bx, sc, kept = (t.cpu().numpy() for t in (boxes, scores, mask))
        assert bx.shape == (B, 20, 100, 4), bx.shape
        if not (np.isfinite(bx).all() and np.isfinite(sc[kept]).all()):
            raise AssertionError(f'{noise}: non-finite detections')
        if not kept.any():
            raise AssertionError(f'{noise}: no detections kept')
        final = 0
        for j in range(B):
            # at most 100 kept, but for ties at the cut (the bf16 heads of
            # a seeded res101 tie often): as the reference, keep them all
            lim = sc[j][limit_per_image(bx[j], sc[j], kept[j], 100)]
            if len(lim) > 100 and (lim > lim.min()).sum() >= 100:
                raise AssertionError('limit_per_image did not cap at 100')
            final += len(lim)
        med = statistics.median(walls)
        name = tag + noise
        result[name] = dict(
            img_per_s=B / med, img_per_s_mean=B * len(walls) / sum(walls),
            chunk_ms=med * 1e3,
            stage_ms={s: statistics.median(v) for s, v in per_stage.items()},
            kept_per_image=float(kept.sum() / B),
            # after the cap of 100 per image; above 100 only for ties
            final_per_image=final / B,
            launches={k: counts[k] for k in PATH_KERNELS[noise]},
            kinds_timed=kinds_drawn(noise, key, range(3 * B, 8 * B)))
        r = result[name]
        log(f'main path {name}: {B / med:.1f} img/s (median of 5 chunks, '
            f'{med * 1e3:.2f} ms/chunk of {B}; mean '
            f'{r["img_per_s_mean"]:.1f} img/s); stages ms: '
            + ', '.join(f'{s} {v:.2f}' for s, v in r['stage_ms'].items())
            + f'; {kept.sum() / B:.1f} kept/image, {final / B:.1f} after '
            f'the cap of 100; launches '
            f'{json.dumps(r["launches"])}'
            + (f'; kinds in the timed chunks {json.dumps(r["kinds_timed"])}'
               if r['kinds_timed'] else '') + f'  [{card}]')
    return result


def entry_path(raw, key) -> dict:
    """Kernel 4's own path: the per-image entry `fused_sap_median` on the
    first sap chunk's images and seeds (drawn as the sap pipeline draws
    them), counters zeroed before and read after; its output must equal
    the batched kernel's."""
    keys = prng.fold_in(key, np.arange(B))
    seeds = torch.from_numpy(prng.randint(keys, (1,), 0, 2**31 - 1)[:, 0]
                             ).to(raw.device)
    img = raw.to(torch.float32)
    zero_counts()
    out = fk.fused_sap_median(img, seeds, 0.4, True)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not counts['fused_sap_median']:
        raise AssertionError('the per-image entry did not launch its kernel')
    if not torch.equal(out, fk.fused_sap_median_batched(img, seeds, 0.4,
                                                        True)):
        raise AssertionError('the per-image entry differs from the batched '
                             'kernel')
    log(f'{ENTRY_PATH}: {counts["fused_sap_median"]} launches for {B} '
        f'images, equal to the batched kernel')
    return dict(launches={'fused_sap_median': counts['fused_sap_median']})


def profiling_path(dev, card: str) -> dict:
    """The profiling entry points at the scripts' size (B = 128), counters
    zeroed before and read after: `profile_sap_breakdown.run` (f32) and
    `u8_run` at their full stage, whose output must equal the plain eval
    noise, and `profile_fused.kernel_only_output`, whose whole (B, hp, w3p)
    output must equal the plain full stage on the same raster.  Then the
    images/s that the scripts print for the same three calls."""
    rng = np.random.RandomState(3)
    f32 = torch.from_numpy(rng.randint(0, 256, (PROFILE_B, H, W, 3)).astype(
        np.float32)).to(dev)
    u8 = f32.to(torch.uint8)
    seeds = torch.arange(PROFILE_B, dtype=torch.int32, device=dev)
    t_f32, t_u8 = PROFILE_TILES['sap_stages_f32'], PROFILE_TILES[
        'sap_stages_u8']
    zero_counts()
    outs = (psb.run(f32, seeds, t_f32, 'full'),
            psb.u8_run(u8, seeds, t_u8, 'full'),
            pf.kernel_only_output(PROFILE_TILES['sap_full_padded'], dev))
    torch.cuda.synchronize()
    counts = launch_counts()
    names = ('sap_stages_f32', 'sap_stages_u8', 'sap_full_padded')
    missing = [k for k in names if not counts[k]]
    if missing:
        raise AssertionError(f'the profiling path did not launch {missing}')
    for out, img in zip(outs, (f32, u8)):
        if not torch.equal(out, fk.fused_sap_median_plain(img, seeds, 0.4,
                                                          True)):
            raise AssertionError('a profiling stage differs from the plain '
                                 'eval noise')
    _, w3p, hp = psb.raster_geometry(H, W, PROFILE_TILES['sap_full_padded'])
    want = fk.sap_stages_plain(
        *pf.padded_raster(PROFILE_TILES['sap_full_padded'], dev), H, 3 * W,
        'full')
    if outs[2].shape != (PROFILE_B, hp, w3p) or not torch.equal(outs[2],
                                                                want):
        raise AssertionError('kernel_only output differs from its plain '
                             'version')
    del outs, want
    ips = {f'run full tile_h={t_f32}': psb.bench(
               lambda im, s: psb.run(im, s, t_f32, 'full'), f32, seeds),
           f'u8_run full tile_h={t_u8}': psb.bench(
               lambda im, s: psb.u8_run(im, s, t_u8, 'full'), u8, seeds),
           f'kernel_only tile_h={PROFILE_TILES["sap_full_padded"]}':
               pf.kernel_only(PROFILE_TILES['sap_full_padded'], dev)}
    log(f'{PROFILE_PATH}: launches {json.dumps({k: counts[k] for k in names})}'
        f'; img/s ' + ', '.join(f'{k} {v:.1f}' for k, v in ips.items())
        + f'  [{card}]')
    return dict(launches={k: counts[k] for k in names}, img_per_s=ips)


# symbols of the port's own kernels (csrc/*.cu), as the profiler names them
OWN_KERNELS = ('sap_median_kernel', 'gauss_blur_kernel', 'mask_kernel',
               'mix_noise_kernel', 'mix_bilateral_kernel', 'brownian_',
               'bloom_kernel', 'bilateral_kernel', 'threefry_kernel',
               'sap_stages_kernel')


def profile_paths(inputs, card: str, noises, tag: str = '') -> dict:
    """Where a chunk's device time goes: for each noise string, one warm
    chunk, then 2 chunks (images 24-39) under torch.profiler.  Reports per
    chunk the wall time (the profiler's own cost included), the device
    kernel time, the device's idle share of the wall time, the port's own
    kernels' time and the largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    model, params, raw, geom, infos, key = inputs
    out = {}
    for noise in noises:
        fn = make_pipeline(noise)
        name = tag + noise

        def chunk(it):
            detect_chunk(model, params, key, list(range(B * it, B * it + B)),
                         raw, geom, infos, fn, BUCKET)

        chunk(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for it in (3, 4):
                chunk(it)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 2 * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type.name == 'CUDA' and e.self_device_time_total]
        busy = sum(e.self_device_time_total for e in kern) / 2e3
        own = sum(e.self_device_time_total for e in kern
                  if any(k in e.key for k in OWN_KERNELS)) / 2e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = dict(
            wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
            own_kernels_ms=own, kernel_names=len(kern),
            top=[(e.key[:90], e.self_device_time_total / 2e3, e.count // 2)
                 for e in top])
        log(f'profile {name}: chunk {wall:.2f} ms, device {busy:.2f} ms, '
            f'idle {1.0 - busy / wall:.1%}, port kernels {own:.3f} ms; top '
            f'(name, ms/chunk, calls): '
            + '; '.join(f'{k} {t:.3f} x{c}' for k, t, c in out[name]['top'])
            + f'  [{card}]')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    dev = 'cuda'
    set_matmul_precision()
    card = card_line()
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    log(f'card: {card}')

    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    log(f'build: {time.perf_counter() - t0:.1f} s '
        f'(nvcc: {json.dumps(cuda_build.build_seconds)})')

    rows = (check_kernels(dev) + check_mix_kernels(dev) + check_threefry(dev)
            + check_sap_stages(dev))
    check_small_chunk(dev)
    vgg = chunk_inputs(dev, 'vgg16')
    e2e = main_path(vgg, card, NOISES)
    e2e[ENTRY_PATH] = entry_path(vgg[2], vgg[5])
    res = chunk_inputs(dev, 'res101')
    e2e.update(main_path(res, card, RES_NOISES, 'res101 '))
    e2e[PROFILE_PATH] = profiling_path(dev, card)
    prof = profile_paths(vgg, card, NOISES)
    prof.update(profile_paths(res, card, RES_NOISES, 'res101 '))
    # each kernel's launches, summed over the main paths that run it
    for r in rows:
        r['launches'] = sum(p['launches'].get(r['name'], 0)
                            for p in e2e.values())
        log(f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} main-path launches  [{card}]")
        for stage, t in r.get('stages', {}).items():
            log(f"  {r['name']} {stage} (B={r['batch']}, tile_h="
                f"{r['tile_h']}): kernel {t['ms']:.3f} ms, plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library {t['library_ms']}  [{card}]")
    if not all(r['launches'] for r in rows):
        raise AssertionError('a kernel was not launched on the main path')
    log(json.dumps({'main_path': e2e, 'profile': prof, 'card': card}))
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
