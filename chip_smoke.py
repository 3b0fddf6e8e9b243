"""Drive the PyTorch/CUDA port's eval chunk on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without a GPU):
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off;
  2. build: nvcc builds the four kernel sources of tpudenoise_torch/csrc
     (six kernels), one nvcc process each, all at once;
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
  4. correctness of the whole chunk on a small input: the card's
     detect_chunk (f32) against the same chunk run on the CPU through the
     plain versions, for sap, gauss and noise_mix_var_all_bilateral;
  5. main path: detect_chunk with a seeded-init vgg16 VOC-21 Faster R-CNN
     in bf16 on (8, 600, 1000, 3) u8 frames, bucket (608, 1024), for
     sap_median_var0.4, gaussian_gaus_blur_var0.1,
     noise_mix_var_all_bilateral, noise_mix_var_all and bloom; 3 warm + 5
     timed chunks each, chunk i holding images 8i..8i+7 (so each chunk
     draws its own noise and, for the mixes, its own kinds); the launch
     counters are zeroed before each path and read after it, and the
     path's kernels must have launched.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config
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
          'noise_mix_var_all_bilateral', 'noise_mix_var_all', 'bloom')
SMALL_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
                'noise_mix_var_all_bilateral')
SOURCES = ('fused_noise', 'nms_mask', 'mix_noise', 'bloom')
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


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
                                                           True), 3, 1)))

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
            raw, seeds, 0.1, True, sigmas=sig), 3, 1)))

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
                         3, 1)))
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
            plain_ms=time_ms(lambda: plain(raw, *args, kinds), 2, 1)))

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
        plain_ms=time_ms(lambda: bloom_apply_scan(img, params), 3, 1)))
    return rows


def _dets(boxes, scores, mask, i, c):
    """(K, 5) kept detections of image i, class c."""
    m = mask[i, c]
    return np.hstack([boxes[i, c][m], scores[i, c][m][:, None]])


def check_small_chunk(dev):
    """The chunk on the card (f32) against the same chunk on the CPU."""
    cfg = default_config()
    model = FasterRCNN('vgg16', num_classes=21, cfg=cfg, dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    raw = torch.from_numpy(rng.randint(0, 256, (2, 120, 200, 3)).astype(
        np.uint8))
    geom = torch.tensor([[120, 200, 120, 200, 1.0]] * 2)
    bucket = (128, 224)
    res = {}
    for d in ('cpu', dev):
        model.to(d)
        p = {k: v.to(d) for k, v in params.items()}
        for noise in SMALL_NOISES:
            out = detect_chunk(model, p, prng.PRNGKey(3), [0, 1],
                               raw.to(d), geom.to(d), geom[:, 2:].to(d),
                               make_pipeline(noise), bucket)
            res[d, noise] = [t.cpu().numpy() for t in out]
    for noise in SMALL_NOISES:
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


COUNTERS = (fk.launches, nms.launches, mk.launches, bl.launches)
MASKS = 'build_suppression_masks_cuda'
# the kernels each main path must launch
PATH_KERNELS = {'sap_median_var0.4': ('fused_sap_median_batched', MASKS),
                'gaussian_gaus_blur_var0.1': ('fused_gaussian_blur', MASKS),
                'noise_mix_var_all_bilateral': ('fused_mix_bilateral', MASKS),
                'noise_mix_var_all': ('fused_mix_noise', MASKS),
                'bloom': ('bloom_batched', MASKS)}


def launch_counts() -> dict:
    return {'fused_sap_median_batched': fk.launches['sap_median'],
            'fused_gaussian_blur': fk.launches['gauss_blur'],
            MASKS: nms.launches['suppression_masks'],
            'fused_mix_noise': mk.launches['mix_noise'],
            'fused_mix_bilateral': mk.launches['mix_bilateral'],
            'bloom_batched': bl.launches['bloom']}


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


def main_path(dev, card: str) -> dict:
    cfg = default_config()
    model = FasterRCNN('vgg16', num_classes=21, cfg=cfg)
    params = model.init(torch.Generator().manual_seed(0))
    model.to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=dev)
    infos = geom[:, 2:].contiguous()
    key = prng.PRNGKey(cfg.RNG_SEED)
    stages = ('noise', 'prep', 'forward', 'postprocess')
    result = {}
    for noise in NOISES:
        noise_fn = make_pipeline(noise)
        walls, per_stage = [], {s: [] for s in stages}
        for counter in COUNTERS:
            for k in counter:
                counter[k] = 0
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
        for j in range(B):
            if limit_per_image(bx[j], sc[j], kept[j], 100).sum() > 100:
                raise AssertionError('limit_per_image did not cap at 100')
        med = statistics.median(walls)
        result[noise] = dict(
            img_per_s=B / med, img_per_s_mean=B * len(walls) / sum(walls),
            chunk_ms=med * 1e3,
            stage_ms={s: statistics.median(v) for s, v in per_stage.items()},
            kept_per_image=float(kept.sum() / B),
            launches={k: counts[k] for k in PATH_KERNELS[noise]},
            kinds_timed=kinds_drawn(noise, key, range(3 * B, 8 * B)))
        log(f'main path {noise}: {B / med:.1f} img/s (median of 5 chunks, '
            f'{med * 1e3:.2f} ms/chunk of {B}; mean '
            f'{result[noise]["img_per_s_mean"]:.1f} img/s); stages ms: '
            + ', '.join(f'{s} {v:.2f}'
                        for s, v in result[noise]['stage_ms'].items())
            + f'; {kept.sum() / B:.1f} kept/image; launches '
            f'{json.dumps(result[noise]["launches"])}'
            + (f'; kinds in the timed chunks '
               f'{json.dumps(result[noise]["kinds_timed"])}'
               if result[noise]['kinds_timed'] else '') + f'  [{card}]')
    return result


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

    rows = check_kernels(dev) + check_mix_kernels(dev)
    check_small_chunk(dev)
    e2e = main_path(dev, card)
    # each kernel's launches, summed over the main paths that run it
    for r in rows:
        r['launches'] = sum(p['launches'].get(r['name'], 0)
                            for p in e2e.values())
        log(f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
            f" ms, {r['launches']} main-path launches  [{card}]")
    if not all(r['launches'] for r in rows):
        raise AssertionError('a kernel was not launched on the main path')
    log(json.dumps({'main_path': e2e, 'card': card}))
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
