"""Time the curvelet post-pass on the card and split it by operation.

    python3 -m tpudenoise_torch.benchmarks.profile_curvelet [--batch 8]

The input is a batch of (B, 600, 1000, 3) u8 frames from RandomState(3),
the shape the `curvelet` string's post-pass gets on the main path.  One
untimed call builds the wedge windows; then:
* events_ms: CUDA events around 3 back-to-back calls of
  `curvelet_denoise_batched`, per call;
* peak_gib: the peak memory of one call above what was allocated before;
* parts: CUDA events around 3 calls each of the two stages of one 4-image
  pass (12 planes): `analysis` (FFT, windows, inverse FFT per band,
  magnitudes) and `threshold` (`quantile_linear` over each plane's 17.4M
  magnitudes);
* top_ops: torch.profiler's device time of one call by operator, the
  largest 12.
The last line is the card's name and power limit; the one before it the
results as JSON.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpudenoise_torch.benchmarks.timing import card_line, time_ms
from tpudenoise_torch.denoise import curvelet as cv

H, W = 600, 1000


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_curvelet runs on a CUDA GPU only')
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (args.batch, H, W, 3))
                              .astype(np.uint8)).to(dev)
    out = {'batch': args.batch, 'shape': [H, W]}
    cv.curvelet_denoise_batched(images)              # builds the windows
    torch.cuda.synchronize()
    out['events_ms'] = time_ms(lambda: cv.curvelet_denoise_batched(images),
                               3, 0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cv.curvelet_denoise_batched(images)
    torch.cuda.synchronize()
    out['peak_gib'] = (torch.cuda.max_memory_allocated() - base) / 2**30

    wins = cv._windows(H, W, 4, 16, dev)
    x = cv.to_unit(images[:cv.CHUNK].to(torch.float32))
    planes = x.permute(0, 3, 1, 2).reshape(-1, H, W)

    def analysis():
        return torch.fft.ifft2(wins * torch.fft.fft2(planes)[:, None]).abs()

    mag = analysis().reshape(planes.shape[0], -1)
    out['parts_ms'] = {
        'analysis': time_ms(analysis, 3, 1),
        'threshold': time_ms(lambda: cv.quantile_linear(mag, 0.5), 3, 1)}
    del mag

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cv.curvelet_denoise_batched(images)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    out['top_ops'] = [dict(name=e.key[:60], calls=e.count,
                           device_ms=e.device_time_total / 1e3)
                      for e in rows[:12]]
    card = card_line()
    out['card'] = card
    print(json.dumps(out))
    print(card)
    return out


if __name__ == '__main__':
    main()
