# Frozen copy of tpudenoise_torch/noise/fused_kernels.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""The fused noise + denoise routes of the sap and gaussian strings, in
plain torch (counterpart of `tpudenoise/noise/pallas_kernels.py`):

* `fused_sap_median_batched`: salt & pepper from a coordinate hash, then a
  3x3 median once or twice (BORDER_REPLICATE; the second pass re-pads from
  the filtered rows).
* `fused_gaussian_blur`: Box-Muller gaussian noise from two coordinate
  hashes, u8 truncation, then a [1,2,1]/4 blur once or twice (REFLECT_101;
  halo rows draw the mirrored row's noise).

Images are (B, H, W, 3) uint8 or float32 u8-domain; the output dtype
follows the input.  The hash runs in int64 masked to 32 bits: torch on
the CPU lacks uint32 `>>` and `<`.
"""

from __future__ import annotations

import numpy as np
import torch


_M32 = 0xFFFFFFFF
_INV255 = float(np.float32(1.0 / 255.0))
_INV2_31 = float(np.float32(1.0 / 2147483648.0))
_TWO_PI = float(np.float32(2.0 * 3.14159265358979))
_TINY = float(np.float32(1e-12))
_SEED2 = 0x2545F491

# ------------------------------------------------------------- hashing --

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32), without int64
    overflow: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash2d(iy: torch.Tensor, ix: torch.Tensor, seed: torch.Tensor
           ) -> torch.Tensor:
    """`pallas_kernels._hash2d` on broadcastable int64 tensors holding
    uint32 values; returns int64 in [0, 2**32)."""
    h = (_mul32(iy, 0x9E3779B9) ^ _mul32(ix, 0x85EBCA6B)
         ^ _mul32(seed, 0xC2B2AE35))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _coords(h: int, w3: int, seeds: torch.Tensor):
    dev = seeds.device
    iy = torch.arange(h, device=dev, dtype=torch.int64)[None, :, None]
    ix = torch.arange(w3, device=dev, dtype=torch.int64)[None, None, :]
    return iy, ix, (seeds.to(torch.int64) & _M32)[:, None, None]


def _sap_threshold(amount: float) -> int:
    return (int(amount * 4294967296.0) if amount < 1.0 else _M32)


# ---------------------------------------------------------- stencils ----

def _shift_rows(t: torch.Tensor, mode: str):
    """Rows y-1 and y+1 of (B, H, W3) with a replicate or reflect border."""
    if mode == 'replicate':
        return (torch.cat([t[:, :1], t[:, :-1]], 1),
                torch.cat([t[:, 1:], t[:, -1:]], 1))
    return (torch.cat([t[:, 1:2], t[:, :-1]], 1),
            torch.cat([t[:, 1:], t[:, -2:-1]], 1))


def _median3(t: torch.Tensor) -> torch.Tensor:
    """3x3 median of (B, R, W3) in the column-sort form of
    `_median3_tile`, BORDER_REPLICATE; lanes +-3 are a pixel's
    same-channel neighbours."""
    w3 = t.shape[-1]
    a, c = _shift_rows(t, 'replicate')
    lo, hi = torch.minimum(a, t), torch.maximum(a, t)
    mid = torch.minimum(hi, c)
    hi = torch.maximum(hi, c)
    lo, mid = torch.minimum(lo, mid), torch.maximum(lo, mid)

    def lr(x):
        return (torch.cat([x[..., :3], x[..., :-3]], -1),
                torch.cat([x[..., 3:w3], x[..., w3 - 3:]], -1))

    (lo_l, lo_r), (mid_l, mid_r), (hi_l, hi_r) = lr(lo), lr(mid), lr(hi)
    maxlo = torch.maximum(torch.maximum(lo_l, lo), lo_r)
    minhi = torch.minimum(torch.minimum(hi_l, hi), hi_r)
    return _med3(maxlo, _med3(mid_l, mid, mid_r), minhi)


def _med3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _blur3(t: torch.Tensor) -> torch.Tensor:
    """[1,2,1]/4 separable blur, REFLECT_101, half-up rounding, in the
    operation order of `_blur3_tile`."""
    a, c = _shift_rows(t, 'reflect')
    v = (0.25 * a + 0.5 * t) + 0.25 * c
    left = torch.cat([v[..., 3:6], v[..., :-3]], -1)
    right = torch.cat([v[..., 3:], left[..., -3:]], -1)
    return torch.floor(((0.25 * left + 0.5 * v) + 0.25 * right) + 0.5)


# ------------------------------------------------------ plain versions --

def fused_sap_median_plain(images: torch.Tensor, seeds: torch.Tensor,
                           amount: float = 0.4, double_filter: bool = True
                           ) -> torch.Tensor:
    b, h, w, _ = images.shape
    x = images.reshape(b, h, 3 * w).to(torch.float32)
    bits = hash2d(*_coords(h, 3 * w, seeds))
    flipped = bits < _sap_threshold(amount)
    salted = (bits & 1) == 1
    noisy = torch.where(flipped & salted, 255.0, x)
    noisy = torch.where(flipped & ~salted, 0.0, noisy)
    out = _median3(noisy)
    if double_filter:
        out = _median3(out)
    return out.reshape(b, h, w, 3).to(images.dtype)


def _gauss_noise(iy, ix, seed, sigma):
    def u01(bits):
        return (bits >> 1).to(torch.float32) * _INV2_31

    tiny = torch.tensor(_TINY, dtype=torch.float32, device=seed.device)
    u1 = torch.maximum(u01(hash2d(iy, ix, seed)), tiny)
    # int32 wraparound of seed + 0x2545F491 == the uint32 sum
    u2 = u01(hash2d(iy, ix, (seed + _SEED2) & _M32))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return sigma * r * torch.cos(_TWO_PI * u2)


def fused_gaussian_blur_plain(images: torch.Tensor, seeds: torch.Tensor,
                              var: float = 0.1, double_filter: bool = True,
                              sigmas: torch.Tensor | None = None
                              ) -> torch.Tensor:
    b, h, w, _ = images.shape
    x = images.reshape(b, h, 3 * w).to(torch.float32)
    sigmas = _sigmas(b, var, sigmas, seeds.device)
    if sigmas is not None:
        iy, ix, seed = _coords(h, 3 * w, seeds)
        z = _gauss_noise(iy, ix, seed, sigmas[:, None, None])
        x = torch.trunc(torch.clamp(x * _INV255 + z, 0.0, 1.0) * 255.0)
    out = _blur3(x)
    if double_filter:
        out = _blur3(out)
    return out.reshape(b, h, w, 3).to(images.dtype)


def _sigmas(b, var, sigmas, device):
    """Per-image noise std: the given (B,) array, else sqrt(var) taken in
    double and rounded to f32 (as the reference's jnp.full); None when no
    noise is applied (var == 0)."""
    if sigmas is not None:
        return sigmas.to(torch.float32)
    if var > 0:
        return torch.full((b,), float(var) ** 0.5, dtype=torch.float32,
                          device=device)
    return None


# ------------------------------------------------------------ wrappers --

def _check(images: torch.Tensor, seeds: torch.Tensor):
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f'images must be (B, H, W, 3), got {images.shape}')
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f'images must be uint8 or float32, got {images.dtype}')
    if seeds.shape != (images.shape[0],) or seeds.dtype != torch.int32:
        raise ValueError('seeds must be (B,) int32')
    if seeds.device != images.device:
        raise ValueError('seeds and images must share a device')
    if images.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {images.device}')


def fused_sap_median_batched(images: torch.Tensor, seeds: torch.Tensor,
                             amount: float = 0.4,
                             double_filter: bool = True) -> torch.Tensor:
    """Salt & pepper + median3 (x2) over a batch; seeds (B,) int32."""
    _check(images, seeds)
    return fused_sap_median_plain(images, seeds, amount, double_filter)


def fused_gaussian_blur(images: torch.Tensor, seeds: torch.Tensor,
                        var: float = 0.1, double_filter: bool = True,
                        sigmas: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian noise + GaussianBlur3 (x2) over a batch; seeds (B,) int32,
    sigmas optional (B,) per-image std overriding `var`."""
    _check(images, seeds)
    if sigmas is not None and (sigmas.shape != (images.shape[0],)
                               or sigmas.device != images.device):
        raise ValueError('sigmas must be (B,) on the images device')
    return fused_gaussian_blur_plain(images, seeds, var, double_filter,
                                     sigmas)

