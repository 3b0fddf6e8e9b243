"""Which stage of the sap + median kernel costs what (counterpart of
`benchmarks/profile_sap_breakdown.py`).

Measures images/s of the kernel cut at each stage, on an edge-padded
raster of (BATCH, 600, 1000, 3) images:
  copy   the raster's image rows written out, no compute;
  noise  + salt & pepper from the coordinate hash;
  med1   + one 3x3 median;
  full   + the second median (the sap_median_var0.4 noise of the eval
         chunk);
for several tile heights, on float32 I/O or (--u8) uint8 I/O.  The tile
height sets the raster's padded height (hp, a multiple of it), as it sets
the reference kernel's grid; the CUDA kernel tiles on its own.

    python3 -m tpudenoise_torch.benchmarks.profile_sap_breakdown [--u8]

Runs on the GPU; `--device cpu` runs the plain versions instead (slow:
give a small `--batch`).  Times come from CUDA events around INNER launches
whose seeds change from launch to launch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpudenoise_torch.benchmarks.timing import card_line, images_per_s
from tpudenoise_torch.noise.fused_kernels import (HALO, LANES, STAGES,
                                                  sap_stages)

H, W = 600, 1000
BATCH = 128
INNER = 8
TILES_F32 = (40, 56, 88, 120, 152)
TILES_U8 = (88, 104, 120, 136)


def raster_geometry(h: int, w: int, tile_h: int):
    """(w3, w3p, hp) of the padded raster of an h x w image."""
    w3 = 3 * w
    return w3, -(-w3 // LANES) * LANES, -(-h // tile_h) * tile_h


def pad_raster(images: torch.Tensor, tile_h: int) -> torch.Tensor:
    """(B, h, w, 3) -> the edge-padded (B, hp + 8, w3p) raster: HALO rows
    above, hp - h + HALO below, w3p - w3 lanes on the right, each a copy of
    the nearest image element."""
    b, h, w, _ = images.shape
    w3, w3p, hp = raster_geometry(h, w, tile_h)
    dev = images.device
    rows = torch.arange(-HALO, hp + HALO, device=dev).clamp(0, h - 1)
    lanes = torch.arange(w3p, device=dev).clamp(max=w3 - 1)
    return images.reshape(b, h, w3)[:, rows][:, :, lanes]


def _run(images, seeds, tile_h, mode):
    b, h, w, _ = images.shape
    out = sap_stages(pad_raster(images, tile_h), seeds, h, 3 * w, mode)
    return out[:, :h, :3 * w].reshape(b, h, w, 3)


def run(images: torch.Tensor, seeds: torch.Tensor, tile_h: int, mode: str
        ) -> torch.Tensor:
    """float32 (B, H, W, 3) images cut at stage `mode`: pad, one kernel,
    slice back to (B, H, W, 3), as the reference's `run`."""
    if images.dtype != torch.float32:
        raise TypeError(f'run takes float32 images, got {images.dtype}')
    return _run(images, seeds, tile_h, mode)


def u8_run(images: torch.Tensor, seeds: torch.Tensor, tile_h: int,
           mode: str) -> torch.Tensor:
    """uint8 (B, H, W, 3) images cut at stage `mode` (the reference's
    `_u8_run`): copy moves bytes, the other stages compute in float32 and
    store through int32."""
    if images.dtype != torch.uint8:
        raise TypeError(f'u8_run takes uint8 images, got {images.dtype}')
    return _run(images, seeds, tile_h, mode)


def bench(fn, images: torch.Tensor, seeds: torch.Tensor, reps: int = 3
          ) -> float:
    """Images/s of fn(images, seeds + i) over INNER launches, mean of
    `reps` timed runs after two warm ones; seeds differ in every launch."""
    return images_per_s(fn, images, seeds, INNER, reps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--u8', action='store_true', help='uint8 I/O')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--batch', type=int, default=BATCH)
    args = ap.parse_args(argv)
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (pass --device cpu to run the '
                             'plain versions)')
        print(f'card: {card_line()}', flush=True)
    rng = np.random.RandomState(3)
    dtype = np.uint8 if args.u8 else np.float32
    images = torch.from_numpy(rng.randint(0, 256, (args.batch, H, W, 3))
                              .astype(dtype)).to(args.device)
    seeds = torch.arange(args.batch, dtype=torch.int32, device=args.device)
    fn, tiles, tag = ((u8_run, TILES_U8, 'u8 ') if args.u8
                      else (run, TILES_F32, ''))
    for tile_h in tiles:
        for mode in STAGES:
            ips = bench(lambda im, s, t=tile_h, m=mode: fn(im, s, t, m),
                        images, seeds)
            print(f'{tag}tile_h={tile_h:4d} mode={mode:6s} {ips:8.1f} img/s',
                  flush=True)


if __name__ == '__main__':
    main()
