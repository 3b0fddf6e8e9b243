"""Where the time of the fused sap + median noise goes (counterpart of
`benchmarks/profile_fused.py`): the whole path (pad, kernel, slice)
against the kernel alone on a pre-padded raster, against the copy
ceiling (read and write the same bytes), in images/s of (B, 600, 1000, 3)
float32 images.

    python3 -m tpudenoise_torch.benchmarks.profile_fused

Runs on the GPU; `--device cpu` runs the plain versions instead (slow).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpudenoise_torch.benchmarks.profile_sap_breakdown import raster_geometry
from tpudenoise_torch.benchmarks.timing import card_line, images_per_s
from tpudenoise_torch.noise.fused_kernels import (HALO,
                                                  fused_sap_median_batched,
                                                  sap_full_padded)

H, W, B = 600, 1000, 128


def timeit(fn, images: torch.Tensor, seeds: torch.Tensor | None = None,
           reps: int = 3, inner: int = 4) -> float:
    """Images/s of `inner` calls fn(images, seeds + i) (fn(images) without
    seeds), mean of `reps` timed runs after two warm ones."""
    return images_per_s(fn, images, seeds, inner, reps)


def padded_raster(tile_h: int, device='cuda'):
    """The reference's kernel_only input: a (B, hp + 8, w3p) float32
    raster of random u8 values (numpy RandomState(0)), halo rows and pad
    lanes included, and seeds 0 .. B-1."""
    _, w3p, hp = raster_geometry(H, W, tile_h)
    rng = np.random.RandomState(0)
    raster = torch.from_numpy(rng.randint(0, 256, (B, hp + 2 * HALO, w3p))
                              .astype(np.float32)).to(device)
    return raster, torch.arange(B, dtype=torch.int32, device=device)


def kernel_only_output(tile_h: int, device='cuda') -> torch.Tensor:
    """The whole (B, hp, w3p) output of the kernel on `padded_raster`, pad
    rows and pad lanes included, as the reference's kernel_only returns
    it."""
    raster, seeds = padded_raster(tile_h, device)
    return sap_full_padded(raster, seeds, H, 3 * W, 0.4)


def kernel_only(tile_h: int, device='cuda') -> float:
    """Images/s of the kernel alone on a pre-padded raster."""
    raster, seeds = padded_raster(tile_h, device)
    return timeit(lambda r, s: sap_full_padded(r, s, H, 3 * W, 0.4),
                  raster, seeds)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    dev = args.device
    if dev == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (pass --device cpu to run the '
                             'plain versions)')
        print(f'card: {card_line()}', flush=True)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.float32)).to(dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)

    # the port's kernel tiles on its own: one full-path row per filter count
    for double in (True, False):
        r = timeit(lambda im, s, d=double: fused_sap_median_batched(
            im, s, amount=0.4, double_filter=d), images, seeds)
        print(f'full path {"double" if double else "single"} median: '
              f'{r:.0f} img/s', flush=True)

    for th in (56, 88, 120):
        print(f'kernel-only tile_h={th}: {kernel_only(th, dev):.0f} img/s',
              flush=True)

    # device-memory copy ceiling: read and write the same bytes
    flat = torch.from_numpy(rng.randint(0, 256, (B, 608, 3072)).astype(
        np.float32)).to(dev)
    r = timeit(lambda x: x + 1.0, flat)
    print(f'x+1 (read+write same bytes): {r:.0f} img/s', flush=True)


if __name__ == '__main__':
    main()
