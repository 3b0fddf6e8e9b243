"""The generator pieces the fused mix and bloom routes need (counterpart of
part of `tpudenoise/noise/generators.py`).

* `wrap_cast_u8` / `saturate_u8`: numpy's float -> uint8 cast (truncate,
  wrap mod 256) and cv2's saturate_cast (round half-even, clamp).
* `u8_unique_count`: the distinct u8 values of an image (skimage's
  poisson quantizer), on the image's device.
* `bloom_params`: the (48, 8) sun-flare compositing steps per key, drawn in numpy
  from the threefry port (`core.prng`) with the float32 arithmetic of the
  reference, so the values are bit-equal.
* `bloom_apply_scan`: the 48-step compositing over a batch, the plain
  version of the bloom kernel (`noise/bloom.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudenoise_torch.core import prng

N_STEPS = 48   # compositing steps: 8 random circles + 40 source rings
N_CIRC = 8


def wrap_cast_u8(x: torch.Tensor) -> torch.Tensor:
    """numpy float -> uint8 cast: truncate toward zero, wrap mod 256 (the
    result takes the divisor's sign, as jnp.mod)."""
    return torch.remainder(torch.trunc(x), 256.0)


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV saturate_cast<uchar>: round half-to-even, clamp."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def u8_unique_count(img: torch.Tensor) -> torch.Tensor:
    """Number of distinct values in [0, 255] of an image after the int32
    cast (truncation), as an int64 scalar tensor on the image's device.
    Values outside [0, 255] are not counted, as in the reference's packed
    presence set."""
    v = img.reshape(-1).to(torch.int32).to(torch.int64)
    v = torch.where((v >= 0) & (v < 256), v, torch.full_like(v, 256))
    return (torch.bincount(v, minlength=257)[:256] > 0).sum()


def _linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` as XLA's CPU code evaluates it:
    the step divide becomes a multiply by f32(1/div), `stop * step`
    re-associates to `iota * (stop / div)`, and that product is contracted
    into the add."""
    f32 = np.float32
    div = num - 1
    i = np.arange(div, dtype=f32)
    rcp = f32(1.0) / f32(div)
    lo = f32(start) * (f32(1.0) - i * rcp)
    return np.append(prng._fma32(i, f32(stop) * rcp, lo), f32(stop))


def bloom_params(key, h: int, w: int) -> np.ndarray:
    """(..., 48, 8) float32 rows (cx, cy, r^2, b, g, r, alpha, 0) of the
    Automold sun flare at flare centre (100, 100), angle -pi/4, for one
    key (2,) or a batch (..., 2): 8 random circles on the mirrored flare
    line, then 40 source rings."""
    f32 = np.float32
    fc = f32(100.0)
    angle = (-math.pi / 4) % (2 * math.pi)
    n_line = (w + 9) // 10
    line_x = np.arange(n_line, dtype=f32) * f32(10.0)
    line_y = f32(200.0) - (f32(math.tan(angle)) * (line_x - fc) + fc)
    rad_hi = max(h // 100 - 2, 1)
    k = prng.split(prng.split(key, N_CIRC), 4)          # (..., 8, 4, 2)
    r_idx = prng.randint(k[..., 1, :], (), 0, n_line)
    rad = prng.randint(k[..., 2, :], (), 1, rad_hi + 1).astype(f32)
    r3 = rad * (rad * rad)
    circ = np.zeros(k.shape[:-2] + (8,), f32)
    circ[..., 0] = np.floor(line_x[r_idx])
    circ[..., 1] = np.floor(line_y[r_idx])
    circ[..., 2] = r3 * r3
    circ[..., 3:6] = prng.randint(k[..., 3, :], (3,), 205, 256)
    circ[..., 6] = prng.uniform(k[..., 0, :], (), 0.05, 0.2)
    n_src = 40
    alphas = _linspace32(0.0, 1.0, n_src)[::-1]
    rads = _linspace32(1.0, 400.0, n_src)
    src = np.zeros(circ.shape[:-2] + (n_src, 8), f32)
    src[..., 0] = src[..., 1] = fc
    src[..., 2] = rads * rads
    src[..., 3:6] = 255.0
    src[..., 6] = alphas * (alphas * alphas)
    return np.concatenate([circ, src], axis=-2)


def bloom_apply_scan(images: torch.Tensor, params: torch.Tensor
                     ) -> torch.Tensor:
    """Sequential overlay/output compositing of (B, H, W, 3) u8-domain
    images with (B, 48, 8) params; returns float32."""
    b, h, w, _ = images.shape
    dev = images.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    overlay = output = images.to(torch.float32)
    for s in range(params.shape[1]):
        p = params[:, s].to(torch.float32)
        dx = xx - p[:, 0, None, None]
        dy = yy - p[:, 1, None, None]
        mask = (dx * dx + dy * dy) <= p[:, 2, None, None]
        overlay = torch.where(mask[..., None], p[:, None, None, 3:6],
                              overlay)
        a = p[:, 6, None, None, None]
        output = saturate_u8(a * overlay + (1.0 - a) * output)
    return output
