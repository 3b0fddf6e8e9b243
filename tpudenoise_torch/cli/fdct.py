"""Standalone curvelet-denoise tool on the GPU (counterpart of
`tpudenoise/cli/fdct.py`): noise an image with the key PRNGKey(3), denoise
it with the curvelet frame, write it.

    python -m tpudenoise_torch.cli.fdct NOISE_TYPE IMAGE [--out PATH]
        [--keep 0.5] [--device cuda|cpu]

IMAGE is read by `utils.image_io.read_bgr` (`.npy` pixels with numpy,
anything else with cv2).  The result is written as `.npy` for `--out
*.npy`, a binary PPM for `*.ppm`, and through cv2 for anything else (the
default `temp.png`, as the JAX tool writes).  `--device cuda` (the
default) needs a CUDA GPU and never falls back to the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Curvelet denoise tool '
                                            '(PyTorch/CUDA port)')
    p.add_argument('noise_type', help='pre-noise to apply, e.g. '
                                      'gaussian_var1.0 or original')
    p.add_argument('img_path')
    p.add_argument('--out', default='temp.png',
                   help='output path: .npy, .ppm, or any format cv2 writes')
    p.add_argument('--keep', type=float, default=0.5,
                   help='fraction of coefficients kept')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where it runs (default cuda; no fallback)')
    return p.parse_args(argv)


def write_image(img: np.ndarray, out: str) -> str:
    """(H, W, 3) uint8 BGR to `out`: .npy, binary PPM, or cv2."""
    if out.endswith('.npy'):
        np.save(out, img)
    elif out.endswith('.ppm'):
        from tpudenoise_torch.cli.demo import write_sheet
        write_sheet(img, out)
    else:
        import cv2
        if not cv2.imwrite(out, img):
            raise OSError(f'cv2 could not write {out}')
    return out


def main(argv=None):
    """Writes the denoised image; returns it ((H, W, 3) uint8)."""
    args = parse_args(argv)
    from tpudenoise_torch.cli.test import resolve_device
    device = resolve_device(args.device)
    import torch
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.denoise.curvelet import curvelet_denoise_u8
    from tpudenoise_torch.noise.pipeline import make_pipeline
    from tpudenoise_torch.utils.image_io import read_bgr

    im = torch.from_numpy(read_bgr(args.img_path)).to(device)
    noisy = make_pipeline(args.noise_type, mode='TEST')(
        prng.PRNGKey(3), im.to(torch.float32)[None])[0]
    out = curvelet_denoise_u8(noisy, keep=args.keep).cpu().numpy()
    write_image(np.clip(out, 0, 255).astype(np.uint8), args.out)
    print(f'wrote {args.out}')
    return out


if __name__ == '__main__':
    main()
