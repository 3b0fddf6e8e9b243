"""Time the eval chunk's two NMS stages and the chunk itself on the card.

    python3 -m tpudenoise_torch.benchmarks.profile_nms [--backbone vgg16]

The inputs are the main path's own: one chunk of `chip_smoke.py`'s main
path (seeded VOC-21 Faster R-CNN in bf16, (8, 600, 1000, 3) u8 frames from
RandomState(3), bucket (608, 1024), `sap_median_var0.4`) runs with
`proposal.nms_packed` (the RPN NMS: 8 x 6000 boxes, 300 kept) and
`harness.nms_fixpoint` (the postprocess NMS: 8 x 20 classes x 300 RoIs,
100 kept) wrapped to record their arguments.  Then each stage is timed on
those arguments:
* events_ms: CUDA events around back-to-back calls, so any wait of the
  host on the device inside a call counts;
* device_ms: torch.profiler's device time of every kernel a call
  launches (the host's waits do not count);
and a hash of its keep indices and mask shows that two versions of the
port keep the same boxes.  Then the chunk: images/s (median of 5 timed
chunks after 3 warm, host clock to synchronize, chunk i holding images
8i..8i+7) and the device's idle share of two chunks under the profiler.

The script uses only entry points the port has had since its first
slice: to time an older tree, copy this file and `timing.py` into its
`tpudenoise_torch/benchmarks/` and run it there.  The last line is the
card's name and power limit; the one before it the results as JSON.  Runs
on the GPU only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from tpudenoise_torch.benchmarks.timing import card_line, device_ms, time_ms
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.eval import harness
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.ops import proposal

B, H, W = 8, 600, 1000
BUCKET = (608, 1024)
NOISE = 'sap_median_var0.4'


def chunk_inputs(dev, backbone: str):
    """The main path's model, params, frames, geometry and key."""
    cfg = default_config()
    model = FasterRCNN(backbone, num_classes=21, cfg=cfg)
    params = model.init(torch.Generator().manual_seed(0))
    model.to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=dev)
    return model, params, raw, geom, prng.PRNGKey(cfg.RNG_SEED)


def capture(inputs, noise_fn) -> dict:
    """The arguments of the chunk's two NMS calls (chunk 0)."""
    model, params, raw, geom, key = inputs
    seen = {}
    wrapped = {'rpn': (proposal, 'nms_packed'),
               'postprocess': (harness, 'nms_fixpoint')}
    originals = {k: getattr(mod, name) for k, (mod, name) in wrapped.items()}

    def recorder(stage):
        def call(*args, **kw):
            seen[stage] = (args, kw)
            return originals[stage](*args, **kw)
        return call

    try:
        for stage, (mod, name) in wrapped.items():
            setattr(mod, name, recorder(stage))
        harness.detect_chunk(model, params, key, list(range(B)), raw,
                             [(geom, BUCKET)], noise_fn)
        torch.cuda.synchronize()
    finally:
        for stage, (mod, name) in wrapped.items():
            setattr(mod, name, originals[stage])
    return {stage: (originals[stage], *seen[stage]) for stage in wrapped}


def digest(keep, mask) -> str:
    h = hashlib.sha256(keep.cpu().numpy().astype(np.int32).tobytes())
    h.update(mask.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def nms_stages(calls: dict, iters: int = 20) -> dict:
    out = {}
    for stage, (fn, args, kw) in calls.items():
        def run(fn=fn, args=args, kw=kw):
            return fn(*args, **kw)
        keep, mask = run()
        out[stage] = dict(
            shape=list(args[0].shape),
            kept=float(mask.sum()) / mask.shape[:-1].numel(),
            events_ms=time_ms(run, iters), device_ms=device_ms(run, iters),
            hash=digest(keep, mask))
    return out


def chunk_rates(inputs, noise_fn) -> dict:
    """img/s of 5 timed chunks after 3 warm; idle share of 2 more chunks
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    model, params, raw, geom, key = inputs

    def chunk(it):
        return harness.detect_chunk(model, params, key,
                                    list(range(B * it, B * it + B)), raw,
                                    [(geom, BUCKET)], noise_fn)

    walls = []
    for it in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(it)
        torch.cuda.synchronize()
        if it >= 3:
            walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in (3, 4):
            chunk(it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == 'CUDA') / 2e3
    med = statistics.median(walls)
    return dict(img_per_s=B / med, chunk_ms=med * 1e3,
                profiled_chunk_ms=wall, device_ms=busy,
                idle_share=1.0 - busy / wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--backbone', default='vgg16')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_nms: no CUDA device', file=sys.stderr)
        return 1
    harness.set_matmul_precision()
    card = card_line()
    inputs = chunk_inputs('cuda', args.backbone)
    noise_fn = make_pipeline(NOISE)
    stages = nms_stages(capture(inputs, noise_fn))
    chunk = chunk_rates(inputs, noise_fn)
    for stage, r in stages.items():
        print(f'{args.backbone} {stage} NMS {r["shape"]}: events '
              f'{r["events_ms"]:.4f} ms, device {r["device_ms"]} ms, '
              f'{r["kept"]:.1f} kept a problem, hash {r["hash"]}  [{card}]')
    print(f'{args.backbone} {NOISE} chunk: {chunk["img_per_s"]:.1f} img/s '
          f'({chunk["chunk_ms"]:.2f} ms), device {chunk["device_ms"]:.2f} '
          f'ms of {chunk["profiled_chunk_ms"]:.2f}, idle '
          f'{chunk["idle_share"]:.1%}  [{card}]')
    print(json.dumps({'backbone': args.backbone, 'nms': stages,
                      'chunk': chunk}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
