"""Drive the PyTorch/CUDA port's eval chunk on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without a GPU):
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off;
  2. build: nvcc builds the seven kernel sources of tpudenoise_torch/csrc
     (fourteen kernels), one nvcc process each, all at once;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes, each timed beside its plain version:
     sap+median (8, 600, 1000, 3) bit-exact on u8 and on f32 values that
     are not integers, with two medians and with one; gaussian+blur same
     shape
     within max |diff| <= 1 on <= 1e-3 of the pixels; packed NMS masks
     (kernel 3) word for word on 8 x 6144 sorted boxes and on the
     postprocess batch (160 x 320 with invalid rows); the greedy walk
     over the words, keep positions bit-exact, on 8 x 6144 with
     max_outputs 300 and 6144 and on the postprocess batch (ties) with
     100, each timed; mix noise and mix + bilateral on
     16 images of 600x1000 whose explicit branches cover all 13 kinds
     (levels from the var_all table; quant palettes and bloom params from
     the port's prologue; the poisson image dark in its left half, so
     both of its samplers run), bit-exact for original, sap, shader, quant,
     bloom, periodic and brownian, and within a mod-256 distance of 1 on
     <= 1e-3 of the elements for the kinds that go through log/exp/cos
     (gaussian's [0, 1] floats within 1e-6); mix + bilateral also timed
     on 8 images of each kind alone and on 8 images drawn by
     noise_mix_var_all_bilateral's plan (with that plan's bound); bloom
     on 8 images, u8 and f32, bit for bit, each timed; the standalone
     bilateral (8, 600, 1000, 3) f32 bit-exact on u8 values (its table
     form) and on [0, 1] floats (its per-tap expf form), each timed; the
     per-image sap + median entry on the same shape bit-exact (integer
     values and non-integers); the
     threefry fields for 8 keys x 1.8M elements: bits and uniforms
     bit-exact, normals within 2 ulp, and poisson's PTRS draw (64 keys x
     1.8M uniforms) bit-exact, each mode timed with its bound; the
     stage-cut sap + median kernels (the profiling forks) on the
     edge-padded raster of (8, 600, 1000, 3) f32 and u8 images, every
     stage, and the full stage on a random raster, bit-exact, and again
     at the profiling scripts' size (B=128), where each is timed;
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
     launched, kernel 3 and the walk exactly twice a chunk each (the RPN
     NMS and the postprocess NMS); then the per-image sap + median entry's
     own path on the
     sap chunk's images and seeds, equal to the batched kernel's result;
     then the same chunk with a seeded-init ResNet-101 (bench_config6's
     model) for sap_median_var0.4; then the profiling path: the two
     profiling entry points (`profile_sap_breakdown.run` / `u8_run` and
     `profile_fused.kernel_only_output`) once each at B=128, each equal
     to its plain version; then the dataset loop: `test_net_batched` over
     16 numpy-written rrData images of 600x1000 (`.npy` pixels) with a
     seeded two-class vgg16 through the port's rrData and voc_eval: 10
     finite APs in [0, 1], chunk 0 equal to detect_chunk +
     limit_per_image (phase 4's tolerance), the ground truth scoring 1.0,
     and the loop's wall time;
  6. where the time goes: two chunks of each string under torch.profiler
     (device kernel time, idle share, the port's own kernels' share, split
     by kernel name with their launches: the threefry draws' device time
     a chunk gets a line of its own), and of the res101 sap chunk; then
     each kernel's device time on phase 3's inputs.
Each kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over 67 T/s (the card's non-tensor f32
rate; integer and transcendental operations counted one each, from the
plain version's per-element operations).  Its ms is by CUDA events over
back-to-back launches in phase 3 (host time between them included);
device_ms is the kernel time of as many launches from torch.profiler,
read in phase 6 so that no profiler session runs before the timed chunks.
The line before the last is the card's name and power limit, the one
before that the kernel table as JSON; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.benchmarks import profile_bilateral as pb
from tpudenoise_torch.benchmarks import profile_fused as pf
from tpudenoise_torch.benchmarks import profile_sap_breakdown as psb
from tpudenoise_torch.benchmarks.profile_bilateral import (MIX_ENTRIES,
                                                            MIX_PLAN)
from tpudenoise_torch.benchmarks.timing import card_line, device_ms, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config, get_output_dir
from tpudenoise_torch.data import synthetic
from tpudenoise_torch.data.voc_like import rrData
from tpudenoise_torch.denoise import bilateral as bil
from tpudenoise_torch.eval.harness import (detect_chunk, limit_per_image,
                                           set_matmul_precision,
                                           test_net_batched)
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
from tpudenoise_torch.utils.image_io import read_bgr

B, H, W = 8, 600, 1000
BUCKET = (608, 1024)
NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
          'noise_mix_var_all_bilateral', 'noise_mix_var_all', 'bloom',
          'speckle_bilateral_var1.0', 'poisson')
SMALL_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
                'noise_mix_var_all_bilateral', 'speckle_bilateral_var1.0',
                'uniform_mean_var0.6', 'quant_var10')
DEV = 'cuda'
MASKS, WALK = 'build_suppression_masks_cuda', 'greedy_keep'
# no Pallas counterpart: the reference's nms_packed sweeps to a fixpoint
WALK_REPLACES = 'tpudenoise/ops/nms.py:365'
SOURCES = ('fused_noise', 'nms_mask', 'mix_noise', 'bloom', 'bilateral',
           'threefry', 'sap_stages')
# the dataset-loop phase: images and noise string
LOOP_IMAGES, LOOP_NOISE = 16, 'sap_median_var0.4'
# the res101 main path: bench_config6's model and noise
RES_NOISES = ('sap_median_var0.4',)
# the stage-cut kernels' symbols: the copy/noise kernel and the walk
SAP_STAGES = ('sap_stages_',)
# the profiling scripts' batch and the tile heights their rows are timed at
PROFILE_B = 128
PROFILE_TILES = {'sap_stages_f32': 56, 'sap_stages_u8': 120,
                 'sap_full_padded': 56}
# poisson's PTRS draw: B images x 4 rounds x (u, v) fields
PTRS_KEYS = 64
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
# kinds through logf/expf/cosf: gaussian, poisson, speckle, uniform,
# gamma, rayleigh (their bound is stated; the rest must be bit-exact)
TRANSCENDENTAL = {1, 2, 4, 6, 9, 10}


def log(*a):
    print(*a, flush=True)


def later(*args, **kw):
    """device_ms(*args, **kw), read only after the main paths (main):
    a torch.profiler session before them would run in their timed
    chunks."""
    return functools.partial(device_ms, *args, **kw)


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


def postprocess_boxes(rng):
    """The postprocess NMS's batch: B images x 20 classes = 160 problems
    of 300 RoIs padded to 320, score-sorted, boxes on a coarse grid (ties
    and long suppression chains), a quarter of the RoIs and the 20 pad
    rows invalid and zero.  Returns (160, 320, 4) f32 boxes and the
    (160, 320) validity on the card."""
    p, r, n = B * 20, 300, 320
    xy = rng.uniform(0, 120, (p, n, 2))
    bx = np.round(np.concatenate([xy, xy + rng.uniform(8, 200, (p, n, 2))],
                                 -1) / 8) * 8
    valid = rng.uniform(size=(p, n)) > 0.25
    valid[:, r:] = False
    bx[~valid] = 0.0
    return (torch.from_numpy(bx.astype(np.float32)).to(DEV),
            torch.from_numpy(valid).to(DEV))


def mask_bound(boxes, words) -> dict:
    """Kernel 3's bound: ~15 operations for each pair i < j, N(N-1)/2 a
    problem; the boxes read and the words written."""
    p, n, _ = boxes.shape
    return bound(boxes.numel() * 4 + words.numel() * 4,
                 15 * p * n * (n - 1) // 2)


def walk_bound(words, keep, max_out) -> dict:
    """The walk's bound: the words it must read.  Per problem, each strip
    up to the one where the max_out-th box is kept (or the last) that
    keeps a box reads its row's words from the strip's own columns on."""
    p, nw, n = words.shape
    kept = keep.long().cpu().numpy()
    nbytes = 0
    for row in kept:
        pos = row[row >= 0]
        last = pos[max_out - 1] // 32 if len(pos) >= max_out else nw - 1
        strips = np.unique(pos // 32)
        nbytes += 4 * sum(n - 32 * s for s in strips if s <= last)
    return bound(nbytes, 0)


def check_greedy(boxes, masks, post_valid) -> dict:
    """The walk kernel bit-exact against its plain version: the RPN's 8 x
    6144 words with max_outputs 300 (the main path's early stop) and 6144
    (no early stop; ~3% of the boxes invalid), and the postprocess batch
    (160 x 320, ties) with 100; each timed."""
    rng = np.random.RandomState(8)
    valid = torch.from_numpy(rng.uniform(size=boxes.shape[:2]) > 0.03).to(
        DEV)
    cases = {'8 x 6144, 300': (masks['8 x 6144'], valid, 300),
             '8 x 6144, 6144': (masks['8 x 6144'], valid, 6144),
             '160 x 320, 100': (masks['160 x 320'], post_valid, 100)}
    row = dict(name=WALK, route='cuda',
               source='tpudenoise_torch/csrc/nms_mask.cu',
               replaces=WALK_REPLACES, max_abs_err=0.0, cases={})
    for what, (words, v, m) in cases.items():
        got = nms.greedy_keep(words, v, m)
        want = nms.greedy_keep_plain(words, v, m)
        torch.cuda.synchronize()
        bad = (got.long() != want).sum().item()
        kept = (want >= 0).sum(1).float().mean().item()
        log(f'kernel greedy_keep {what}: {bad} of {got.numel()} positions '
            f'differ; {kept:.1f} kept a problem (bit-exact required)')
        if bad or kept == 0:
            raise AssertionError(f'greedy_keep differs from its plain '
                                 f'version at {what}')
        row['cases'][what] = dict(
            ms=time_ms(lambda: nms.greedy_keep(words, v, m), 20),
            # read after the main paths: bind this case's inputs now
            device_ms=later(lambda words=words, v=v, m=m: nms.greedy_keep(
                words, v, m), 20, ('greedy_kernel',)),
            plain_ms=time_ms(lambda: nms.greedy_keep_plain(words, v, m), 2,
                             1),
            kept=kept, **walk_bound(words, want, m))
    row.update({k: v for k, v in row['cases']['8 x 6144, 300'].items()
                if k != 'kept'})
    return row


def check_kernels(dev) -> list:
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.from_numpy(rng.randint(0, 2**31 - 1, B).astype(
        np.int32)).to(dev)
    rows = []

    # kernel 1: bit-exact on u8 (the packed route) and on f32 values that
    # are not integers (the float route), with two medians and with one;
    # the fractions from a stream of their own, so that the later checks'
    # inputs stay as they were
    frac = raw.to(torch.float32) + torch.from_numpy(np.random.RandomState(
        4).uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32)).to(dev)
    err = 0.0
    for what, im in (('u8', raw), ('f32 non-integers', frac)):
        for double in (True, False):
            got = fk.fused_sap_median_batched(im, seeds, 0.4, double)
            want = fk.fused_sap_median_plain(im, seeds, 0.4, double)
            torch.cuda.synchronize()
            e = (got.double() - want.double()).abs().max().item()
            log(f'kernel sap_median {what}, double={double}: max |diff| {e} '
                f'(bit-exact required)')
            if e != 0:
                raise AssertionError(f'sap_median kernel differs from its '
                                     f'plain version on {what}')
            err = max(err, e)
    rows.append(dict(
        name='fused_sap_median_batched', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:389',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median_batched(raw, seeds, 0.4,
                                                       True), 20),
        device_ms=later(lambda: fk.fused_sap_median_batched(
            raw, seeds, 0.4, True), 20, ('sap_median_kernel',)),
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
        device_ms=later(lambda: fk.fused_gaussian_blur(
            raw, seeds, 0.1, True, sigmas=sig), 20, ('gauss_blur_kernel',)),
        plain_ms=time_ms(lambda: fk.fused_gaussian_blur_plain(
            raw, seeds, 0.1, True, sigmas=sig), 3, 1),
        **bound(2 * raw.numel(), OPS['gauss_blur'] * raw.numel())))

    # kernel 3: word for word at the TEST budget (6000 -> 6144) and on the
    # postprocess batch; then the greedy walk over its words
    boxes = torch.from_numpy(nms_boxes(rng, B, 6144)).to(dev)
    post, post_valid = postprocess_boxes(rng)
    masks = {}
    for what, bx, t in (('8 x 6144', boxes, 0.7), ('160 x 320', post, 0.3)):
        got = nms.build_suppression_masks_cuda(bx, t)
        want = nms.build_suppression_masks(bx, t)
        torch.cuda.synchronize()
        bad = (got != want).sum().item()
        log(f'kernel suppression_masks {what}: {bad} of {got.numel()} words '
            f'differ; {int((got != 0).sum())} non-zero words')
        if bad or not got.any():
            raise AssertionError(f'suppression mask kernel differs from its '
                                 f'plain version at {what}')
        masks[what] = got
    got = masks['8 x 6144']
    rows.append(dict(
        name=MASKS, route='cuda',
        source='tpudenoise_torch/csrc/nms_mask.cu',
        replaces='tpudenoise/ops/nms.py:234', max_abs_err=0.0,
        ms=time_ms(lambda: nms.build_suppression_masks_cuda(boxes, 0.7), 20),
        device_ms=later(lambda: nms.build_suppression_masks_cuda(
            boxes, 0.7), 20, ('mask_kernel',)),
        plain_ms=time_ms(lambda: nms.build_suppression_masks(boxes, 0.7),
                         3, 1),
        **mask_bound(boxes, got),
        post_ms=time_ms(lambda: nms.build_suppression_masks_cuda(post, 0.3),
                        20),
        post_device_ms=later(lambda: nms.build_suppression_masks_cuda(
            post, 0.3), 20, ('mask_kernel',)),
        post_plain_ms=time_ms(lambda: nms.build_suppression_masks(post, 0.3),
                              3, 1),
        post_bound_ms=mask_bound(post, masks['160 x 320'])['bound_ms']))
    rows.append(check_greedy(boxes, masks, post_valid))

    # kernel 4: the per-image entry of kernel 1 (f32 I/O), bit-exact on
    # integer values and on values that are not integers
    img = raw.to(torch.float32)
    err = 0.0
    for what, im in (('integers', img), ('non-integers', frac)):
        got = fk.fused_sap_median(im, seeds, 0.4, True)
        torch.cuda.synchronize()
        e = (got - fk.fused_sap_median_plain(im, seeds, 0.4, True)).abs(
        ).max().item()
        log(f'kernel sap_median (per image) on {what}: max |diff| {e} '
            f'(bit-exact required)')
        if e != 0:
            raise AssertionError(f'per-image sap_median differs from its '
                                 f'plain version on {what}')
        err = max(err, e)
    rows.append(dict(
        name='fused_sap_median', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:339',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median(img, seeds, 0.4, True), 20),
        device_ms=later(lambda: fk.fused_sap_median(img, seeds, 0.4, True),
                        20, ('sap_median_kernel',), per_call=B),
        plain_ms=time_ms(lambda: fk.fused_sap_median_plain(img, seeds, 0.4,
                                                           True), 3, 1),
        **bound(8 * img.numel(), OPS['sap_median'] * img.numel())))

    # kernel 5: the standalone bilateral, bit-exact, on u8-domain floats
    # with a zero band (as clipped noise makes; the table form) and on
    # [0, 1] floats (the gaussian kind's output; the per-tap expf form)
    band = img.clone()
    band[:, :, :7] = 0.0
    unit = torch.from_numpy(rng.uniform(0.0, 1.0, (B, H, W, 3)).astype(
        np.float32)).to(dev)
    err = 0.0
    for what, x in (('u8 values', band), ('[0, 1] floats', unit)):
        got = bil.bilateral_batched(x)
        torch.cuda.synchronize()
        e = (got - bil.bilateral_plain(x)).abs().max().item()
        log(f'kernel bilateral on {what}: max |diff| {e} (bit-exact '
            f'required)')
        if e != 0:
            raise AssertionError(f'bilateral kernel differs from its plain '
                                 f'version on {what}')
        err = max(err, e)
    rows.append(dict(
        name='bilateral_batched', route='cuda',
        source='tpudenoise_torch/csrc/bilateral.cu',
        replaces='tpudenoise/denoise/pallas_bilateral.py:138',
        max_abs_err=float(err),
        ms=time_ms(lambda: bil.bilateral_batched(band), 20),
        device_ms=later(lambda: bil.bilateral_batched(band), 20,
                        ('bilateral_kernel',)),
        unit_floats_ms=time_ms(lambda: bil.bilateral_batched(unit), 20),
        unit_floats_device_ms=later(
            lambda: bil.bilateral_batched(unit), 20, ('bilateral_kernel',)),
        plain_ms=time_ms(lambda: bil.bilateral_plain(band), 3, 1),
        **bound(8 * band.numel(), OPS['bilateral'] * band.numel())))
    return rows


def check_threefry(dev) -> list:
    """The threefry fields of the main paths against the plain version on
    the card: 8 keys x 1.8M elements (one (8, 600, 1000, 3) field) in all
    three modes, bits and uniforms bit-exact, normals within 2 ulp, and
    poisson's PTRS draw (64 keys x 1.8M uniforms) bit-exact; each timed
    with its bound.  The row's own numbers are the speckle draw's
    (normals)."""
    n = H * W * 3
    keys = torch.from_numpy(prng.split(prng.PRNGKey(11), B).astype(
        np.int64)).to(dev)
    ptrs = torch.from_numpy(prng.split(prng.PRNGKey(12), PTRS_KEYS).astype(
        np.int64)).to(dev)
    scale = float(prng._SQRT2)
    worst = 0
    modes = {}
    for mode, k in (('bits', keys), ('uniform', keys), ('normal', keys),
                    ('uniform', ptrs)):
        got = prng.threefry_draw(k, n, mode, 0.0, 1.0, scale)
        want = prng.threefry_draw_plain(k, n, mode, 0.0, 1.0, scale)
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs()
        m = ulp.max().item()
        what = f'{mode} {k.shape[0]} x {n}'
        log(f'kernel threefry {what}: max {m} ulp, '
            f'{(ulp > 0).double().mean().item():.2e} differ (bound: 0 for '
            f'bits and uniforms, 2 ulp for normals)')
        if m > (2 if mode == 'normal' else 0):
            raise AssertionError(f'threefry {what} outside its bound')
        worst = max(worst, (got - want).abs().max().item()
                    if mode == 'normal' else 0.0)
        del got, want, ulp

        def draw(k=k, mode=mode):
            return prng.threefry_draw(k, n, mode, 0.0, 1.0, scale)

        modes[what] = dict(ms=time_ms(draw, 20),
                           device_ms=later(draw, 20, ('threefry_kernel',)),
                           **bound(4 * k.shape[0] * n,
                                   OPS[mode] * k.shape[0] * n))
    bits_cpu = prng.threefry_draw(keys[:1].cpu(), 4096, 'bits')
    if not torch.equal(bits_cpu, prng.threefry_draw(keys[:1], 4096,
                                                    'bits').cpu()):
        raise AssertionError('threefry bits differ between card and CPU')
    row = modes[f'normal {B} x {n}']
    return [dict(
        name='threefry_draw', route='cuda',
        source='tpudenoise_torch/csrc/threefry.cu',
        replaces='tpudenoise/noise/generators.py:140',
        max_abs_err=worst, ms=row['ms'], device_ms=row['device_ms'],
        plain_ms=time_ms(lambda: prng.threefry_draw_plain(
            keys, n, 'normal', 0.0, 1.0, scale), 3, 1),
        modes=modes, **{k: row[k] for k in ('bound_ms', 'bound_by',
                                             'library_ms')})]


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
                # read after the main paths: bind this stage's inputs now
                device_ms=later(lambda run=run, big=big, stage=stage: run(
                    big, big_seeds, stage), 20, SAP_STAGES),
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
    raw = rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    # the poisson image dark in its left half: lam < 10 there, so the
    # inverse CDF runs beside PTRS in one warp at the band's edge
    poisson = [k for k, _ in MIX_ENTRIES].index(int(Kind.POISSON))
    raw[poisson, :, :W // 2] //= 32
    raw = torch.from_numpy(raw).to(dev)
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
            device_ms=later(lambda fn=fn: fn(raw, *args, kinds), 10, (
                name.replace('fused_', '') + '_kernel', 'brownian_')),
            plain_ms=time_ms(lambda: plain(raw, *args, kinds), 2, 1),
            **bound(5 * raw.numel(), H * W * 3 * sum(
                MIX_OPS[k] + (OPS['bilateral'] if 'bilateral' in name
                              else 0) for k, _ in MIX_ENTRIES))))

    # kernel 7 at the main path's batch: 8 images drawn by the plan (its
    # bound from the kinds drawn), and 8 images of each kind alone, at the
    # kind's first level in MIX_ENTRIES
    row = rows[-1]
    praw, pkinds, pargs, drawn = pb.plan_inputs(dev)
    row['plan_kinds'] = drawn
    row['plan_ms'] = time_ms(
        lambda: mk.fused_mix_bilateral(praw, *pargs, pkinds), 10)
    row['plan_device_ms'] = later(
        lambda: mk.fused_mix_bilateral(praw, *pargs, pkinds), 10,
        ('mix_bilateral_kernel', 'brownian_'))
    row['plan_bound_ms'] = bound(5 * praw.numel(), H * W * 3 * sum(
        MIX_OPS[Kind[k.upper()]] + OPS['bilateral']
        for k in drawn))['bound_ms']
    row['per_kind_ms'] = {}
    for kind, level in MIX_ENTRIES[:13]:
        kraw, kk, kargs = pb.mix_inputs(dev, [(kind, level)] * B,
                                        seed=11 + kind)
        row['per_kind_ms'][Kind(kind).name.lower()] = time_ms(
            lambda: mk.fused_mix_bilateral(kraw, *kargs, kk), 10)
    log(f'kernel fused_mix_bilateral on {MIX_PLAN} chunk 0 '
        f'({", ".join(drawn)}): {row["plan_ms"]:.3f} ms, bound '
        f'{row["plan_bound_ms"]:.4f} ms; by kind (8 images each, ms): '
        + ', '.join(f'{k} {t:.3f}' for k, t in row['per_kind_ms'].items()))

    img = raw[:B]
    params = torch.from_numpy(bloom_params(prng.split(prng.PRNGKey(6), B),
                                           H, W)).to(dev)
    forms = {'u8': img, 'f32': img.to(torch.float32)}
    for form, x in forms.items():
        got = bl.bloom_batched(x, params)
        torch.cuda.synchronize()
        bad = (got.view(torch.int32) != bloom_apply_scan(x, params).view(
            torch.int32)).sum().item()
        log(f'kernel bloom on {form}: {bad} of {got.numel()} words differ '
            f'(bit-exact required)')
        if bad:
            raise AssertionError(f'bloom kernel differs from its plain '
                                 f'version on {form}')
    f32 = forms['f32']
    rows.append(dict(
        name='bloom_batched', route='cuda',
        source='tpudenoise_torch/csrc/bloom.cu',
        replaces='tpudenoise/noise/pallas_bloom.py:77', max_abs_err=0.0,
        ms=time_ms(lambda: bl.bloom_batched(img, params), 20),
        device_ms=later(lambda: bl.bloom_batched(img, params), 20,
                        ('bloom_kernel',)),
        f32_ms=time_ms(lambda: bl.bloom_batched(f32, params), 20),
        f32_device_ms=later(lambda: bl.bloom_batched(f32, params), 20,
                            ('bloom_kernel',)),
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
# the kernels each main path must launch, besides the two NMS kernels
# (twice a chunk each: the RPN's NMS and the postprocess NMS)
PATH_KERNELS = {'sap_median_var0.4': ('fused_sap_median_batched',),
                'gaussian_gaus_blur_var0.1': ('fused_gaussian_blur',),
                'noise_mix_var_all_bilateral': ('fused_mix_bilateral',),
                'noise_mix_var_all': ('fused_mix_noise',),
                'bloom': ('bloom_batched',),
                'speckle_bilateral_var1.0': ('threefry_draw',
                                             'bilateral_batched'),
                'poisson': ('threefry_draw',)}
NMS_KERNELS = (MASKS, WALK)
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
            WALK: nms.launches['greedy_keep'],
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
        if any(counts[k] != 2 * 8 for k in NMS_KERNELS):
            raise AssertionError(f'{noise}: not 2 launches a chunk of each '
                                 f'NMS kernel ({counts})')
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
            launches={k: counts[k] for k in PATH_KERNELS[noise]
                      + NMS_KERNELS},
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


def dataset_loop(card: str) -> dict:
    """The dataset loop on the card: a numpy-written rrData dataset of
    LOOP_IMAGES 600x1000 `.npy` images under build/ (filled rectangles as
    'person' boxes), `test_net_batched` with a seeded vgg16 (bf16) of
    rrData's two classes on sap_median_var0.4 through the port's rrData.
    The 10 APs must be finite and in [0, 1]; chunk 0's detections must
    match detect_chunk + limit_per_image on the same images and keys
    (phase 4's tolerance); the ground truth as detections must score
    1.0."""
    import os.path as osp
    import pickle
    import shutil

    root = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_data')
    shutil.rmtree(root, ignore_errors=True)
    pdir, gt = synthetic.write_rrdata(root, LOOP_IMAGES, (H, W), seed=12)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    imdb = rrData('test', config=cfg, pixel_dir=pdir)
    model = FasterRCNN('vgg16', num_classes=imdb.num_classes,
                       cfg=default_config())
    params = model.init(torch.Generator().manual_seed(0))
    model.to(DEV)
    params = {k: v.to(DEV) for k, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aps = test_net_batched(model, params, imdb, 'vgg16_seeded', LOOP_NOISE,
                           eval_batch=B, config=cfg, bucket=BUCKET)
    wall = time.perf_counter() - t0
    if len(aps) != 10 or not all(np.isfinite(a) and 0 <= a <= 1
                                 for a in aps):
        raise AssertionError(f'dataset loop: APs {aps}')
    out_dir = get_output_dir(imdb.name, 'vgg16_seeded', cfg)
    with open(osp.join(out_dir, 'detections.pkl'), 'rb') as f:
        loop_dets = pickle.load(f)[1]

    # chunk 0 again through detect_chunk, as the loop builds it
    raw = torch.from_numpy(np.stack([read_bgr(imdb.image_path_at(i))
                                     for i in range(B)])).to(DEV)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=DEV)
    boxes, scores, mask = (t.cpu().numpy() for t in detect_chunk(
        model, params, prng.PRNGKey(cfg.RNG_SEED), list(range(B)), raw,
        geom, geom[:, 2:], make_pipeline(LOOP_NOISE, mode='TEST'), BUCKET))
    kept = np.stack([limit_per_image(boxes[j], scores[j], mask[j], 100)
                     for j in range(B)])
    matched = total = 0
    for j in range(B):
        want = _dets(boxes, scores, kept, j, 0)
        got = loop_dets[j]
        if abs(len(want) - len(got)) > 1:
            raise AssertionError(f'dataset loop image {j}: {len(got)} '
                                 f'detections, detect_chunk {len(want)}')
        for row in want:
            total += 1
            matched += bool(got.size and np.abs(got - row).max(1).min()
                            < 0.5)
    if total == 0 or matched / total < 0.95:
        raise AssertionError(f'dataset loop chunk 0: {matched}/{total} '
                             f'detections match detect_chunk')
    gt_aps = imdb.evaluate_detections(synthetic.gt_detections(imdb, gt),
                                      osp.join(root, 'gt_eval'))
    if len(gt_aps) != 10 or not np.allclose(gt_aps, 1.0, rtol=1e-12,
                                            atol=0):
        raise AssertionError(f'ground truth scored {gt_aps}')
    log(f'dataset loop: {LOOP_IMAGES} images of {H}x{W} in {wall:.2f} s '
        f'({LOOP_IMAGES / wall:.1f} img/s, load and evaluation included); '
        f'AP@.5 {aps[0]:.4f}, AP@[.5,.95] {np.mean(aps):.4f}; chunk 0 '
        f'{matched}/{total} detections match detect_chunk; ground truth '
        f'scores {np.mean(gt_aps):.4f}  [{card}]')
    return dict(images=LOOP_IMAGES, wall_s=wall, img_per_s=LOOP_IMAGES / wall,
                aps=aps, chunk0_matched=[matched, total])


# symbols of the port's own kernels (csrc/*.cu), as the profiler names
# them; a name that holds another comes first
OWN_KERNELS = ('sap_median_kernel', 'gauss_blur_kernel', 'mask_kernel',
               'greedy_kernel',
               'mix_noise_kernel', 'mix_bilateral_kernel', 'brownian_',
               'bloom_kernel', 'bilateral_kernel', 'threefry_kernel',
               SAP_STAGES[0])


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
        # the port's own kernels by name (each kernel under the first
        # name it holds): (ms, launches) a chunk
        own_by = {}
        for e in kern:
            k = next((k for k in OWN_KERNELS if k in e.key), None)
            if k:
                t, c = own_by.get(k, (0.0, 0.0))
                own_by[k] = (t + e.self_device_time_total / 2e3,
                             c + e.count / 2)
        own = sum(t for t, _ in own_by.values())
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = dict(
            wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
            own_kernels_ms=own, own_by_kernel=own_by,
            kernel_names=len(kern),
            top=[(e.key[:90], e.self_device_time_total / 2e3, e.count // 2)
                 for e in top])
        log(f'profile {name}: chunk {wall:.2f} ms, device {busy:.2f} ms, '
            f'idle {1.0 - busy / wall:.1%}, port kernels {own:.3f} ms; top '
            f'(name, ms/chunk, calls): '
            + '; '.join(f'{k} {t:.3f} x{c}' for k, t, c in out[name]['top'])
            + f'  [{card}]')
        log(f'profile {name}: port kernels a chunk (ms, launches): '
            + '; '.join(f'{k} {t:.4f} x{c:g}' for k, (t, c) in own_by.items())
            + f'  [{card}]')
        if 'threefry_kernel' in own_by:
            t, c = own_by['threefry_kernel']
            log(f'profile {name}: threefry device time a chunk {t:.4f} ms in '
                f'{c:g} launches  [{card}]')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    dev = DEV
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
    loop = dataset_loop(card)
    prof = profile_paths(vgg, card, NOISES)
    prof.update(profile_paths(res, card, RES_NOISES, 'res101 '))
    # the kernels' device times (`later`): only now, after every timed
    # chunk
    def resolve(d):
        for k, v in d.items():
            if isinstance(v, functools.partial):
                d[k] = v()
            elif isinstance(v, dict):
                resolve(v)

    for r in rows:
        resolve(r)
    # each kernel's launches, summed over the main paths that run it
    for r in rows:
        r['launches'] = sum(p['launches'].get(r['name'], 0)
                            for p in e2e.values())
        log(f"{r['name']}: kernel {r['ms']:.3f} ms"
            + (f" (device {r['device_ms']} ms)" if 'device_ms' in r
               else '')
            + f", plain {r['plain_ms']:.3f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} main-path launches  [{card}]")
        for what, t in r.get('modes', {}).items():
            log(f"  {r['name']} {what}: kernel {t['ms']:.4f} ms (device "
                f"{t['device_ms']} ms), bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})  [{card}]")
        if 'f32_ms' in r:
            log(f"  {r['name']} on f32 images: kernel {r['f32_ms']:.4f} ms "
                f"(device {r['f32_device_ms']} ms)  [{card}]")
        for stage, t in r.get('stages', {}).items():
            log(f"  {r['name']} {stage} (B={r['batch']}, tile_h="
                f"{r['tile_h']}): kernel {t['ms']:.3f} ms (device "
                f"{t['device_ms']} ms), plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library {t['library_ms']}  [{card}]")
    if not all(r['launches'] for r in rows):
        raise AssertionError('a kernel was not launched on the main path')
    log(json.dumps({'main_path': e2e, 'dataset_loop': loop,
                    'profile': prof, 'card': card}))
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
