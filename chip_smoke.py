"""Drive the PyTorch/CUDA port's eval chunk on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without a GPU):
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off;
  2. build: nvcc builds the three kernels from tpudenoise_torch/csrc;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes: sap+median (8, 600, 1000, 3) u8 bit-exact,
     gaussian+blur same shape within max |diff| <= 1 on <= 1e-3 of the
     pixels, packed NMS masks 8 x 6144 sorted boxes word for word; each
     timed beside its plain version;
  4. correctness of the whole chunk on a small input: the card's
     detect_chunk (f32) against the same chunk run on the CPU through the
     plain versions;
  5. main path: detect_chunk with a seeded-init vgg16 VOC-21 Faster R-CNN
     in bf16 on (8, 600, 1000, 3) u8 frames, bucket (608, 1024), for
     sap_median_var0.4 and gaussian_gaus_blur_var0.1; 3 warm + 5 timed
     chunks each; every kernel's launch count must rise.
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
from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.ops import nms

B, H, W = 8, 600, 1000
BUCKET = (608, 1024)
NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1')


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
        for noise in NOISES:
            out = detect_chunk(model, p, prng.PRNGKey(3), [0, 1],
                               raw.to(d), geom.to(d), geom[:, 2:].to(d),
                               make_pipeline(noise), bucket)
            res[d, noise] = [t.cpu().numpy() for t in out]
    for noise in NOISES:
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
    idx = list(range(B))
    stages = ('noise', 'prep', 'forward', 'postprocess')
    result = {}
    for counter in (fk.launches, nms.launches):
        for k in counter:
            counter[k] = 0
    for noise in NOISES:
        noise_fn = make_pipeline(noise)
        walls, per_stage = [], {s: [] for s in stages}
        for it in range(8):
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
        bx, sc, mk = (t.cpu().numpy() for t in (boxes, scores, mask))
        assert bx.shape == (B, 20, 100, 4), bx.shape
        if not (np.isfinite(bx).all() and np.isfinite(sc[mk]).all()):
            raise AssertionError(f'{noise}: non-finite detections')
        if not mk.any():
            raise AssertionError(f'{noise}: no detections kept')
        for j in range(B):
            if limit_per_image(bx[j], sc[j], mk[j], 100).sum() > 100:
                raise AssertionError('limit_per_image did not cap at 100')
        med = statistics.median(walls)
        result[noise] = dict(img_per_s=B / med, chunk_ms=med * 1e3,
                             stage_ms={s: statistics.median(v)
                                       for s, v in per_stage.items()},
                             kept_per_image=float(mk.sum() / B))
        log(f'main path {noise}: {B / med:.1f} img/s (median of 5 chunks, '
            f'{med * 1e3:.2f} ms/chunk of {B}); stages ms: '
            + ', '.join(f'{s} {v:.2f}'
                        for s, v in result[noise]['stage_ms'].items())
            + f'; {mk.sum() / B:.1f} kept/image  [{card}]')
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
    for name in ('fused_noise', 'nms_mask'):
        cuda_build.library(name)
    log(f'build: {time.perf_counter() - t0:.1f} s '
        f'(nvcc: {json.dumps(cuda_build.build_seconds)})')

    rows = check_kernels(dev)
    check_small_chunk(dev)
    e2e = main_path(dev, card)
    counts = {'fused_sap_median_batched': fk.launches['sap_median'],
              'fused_gaussian_blur': fk.launches['gauss_blur'],
              'build_suppression_masks_cuda':
                  nms.launches['suppression_masks']}
    log(f'main-path launches: {json.dumps(counts)}')
    for r in rows:
        r['launches'] = counts[r['name']]
        log(f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
            f" ms  [{card}]")
    if not all(counts.values()):
        raise AssertionError(f'a kernel was not launched on the main path: '
                             f'{counts}')
    log(json.dumps({'main_path': e2e, 'card': card}))
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
