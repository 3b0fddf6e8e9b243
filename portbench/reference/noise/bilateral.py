# Frozen copy of tpudenoise_torch/denoise/bilateral.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""cv2-style bilateral filter, d=9 (counterpart of
`tpudenoise/denoise/pallas_bilateral.py`: `bilateral_pallas` and its body
`_bilateral_body`), in plain torch.

The taps are the disk dx^2 + dy^2 <= 16 (49 taps), summed dy outer, dx
inner.  BORDER_CONSTANT: the zero border takes part in the sums.  One
colour weight per pixel pair, exp(gc * d * d) with d the sum of the three
channels' |difference| (B + G, then + R), times the spatial weight; both
constants are the float32 values of the reference's Python doubles.
Output round(num / den), half to even.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


RADIUS = 4

@functools.lru_cache(maxsize=None)
def taps(sigma_space: float = 100.0) -> tuple:
    """((dy, dx, f32 spatial weight), ...) in the reference's order."""
    gs = -0.5 / (sigma_space * sigma_space)
    out = []
    for dy in range(-RADIUS, RADIUS + 1):
        for dx in range(-RADIUS, RADIUS + 1):
            r2 = dy * dy + dx * dx
            if math.sqrt(r2) <= RADIUS:
                out.append((dy, dx, float(np.float32(math.exp(gs * r2)))))
    return tuple(out)


def color_coeff(sigma_color: float = 20.0) -> float:
    return float(np.float32(-0.5 / (sigma_color * sigma_color)))


def bilateral_plain(images: torch.Tensor, sigma_color: float = 20.0,
                    sigma_space: float = 100.0) -> torch.Tensor:
    """(B, H, W, 3) float32 -> float32."""
    b, h, w, _ = images.shape
    r = RADIUS
    x = images.to(torch.float32)
    pad = torch.nn.functional.pad(x, (0, 0, r, r, r, r))
    gc = color_coeff(sigma_color)
    num = torch.zeros_like(x)
    den = torch.zeros((b, h, w), dtype=torch.float32, device=x.device)
    for dy, dx, sw in taps(sigma_space):
        v = pad[:, r + dy:r + dy + h, r + dx:r + dx + w]
        a = (v - x).abs()
        d = (a[..., 0] + a[..., 1]) + a[..., 2]
        wgt = sw * torch.exp((gc * d) * d)
        num = num + wgt[..., None] * v
        den = den + wgt
    return torch.round(num / den[..., None])


def bilateral_batched(images: torch.Tensor, sigma_color: float = 20.0,
                      sigma_space: float = 100.0) -> torch.Tensor:
    """The d=9 bilateral of (B, H, W, 3) float32 u8-domain images, one
    pass over the batch; returns float32."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f'images must be (B, H, W, 3), got {images.shape}')
    if images.dtype != torch.float32:
        raise TypeError(f'images must be float32, got {images.dtype}')
    return bilateral_plain(images, sigma_color, sigma_space)

