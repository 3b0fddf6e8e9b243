"""Image reading for the dataset loop, on hosts with or without cv2.

The GPU machine has neither cv2 nor PIL, so the loop reads pixels that
`python -m tpudenoise_torch.data.cache_pixels` decoded once with
`cv2.imread` into `.npy` files: the card then reads exactly the pixels
the reference reads.  Any other path goes through cv2 or PIL, imported
only when such a path is read (the CPU-side parity path).
"""

from __future__ import annotations

import numpy as np


def _is_npy(path: str) -> bool:
    return str(path).endswith('.npy')


def read_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR pixels of an image: `np.load` for a `.npy`
    file, `cv2.imread` for anything else."""
    if _is_npy(path):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f'{path}: expected (H, W, 3) uint8 BGR, got '
                             f'{img.shape} {img.dtype}')
        return img
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def image_hw(path: str) -> tuple:
    """(H, W) of an image without decoding its pixels: the `.npy` header,
    or PIL's for anything else."""
    if _is_npy(path):
        return tuple(np.load(path, mmap_mode='r').shape[:2])
    import PIL.Image
    with PIL.Image.open(path) as im:
        return im.size[::-1]
