"""Fused noise + denoise kernels (counterpart of
`tpudenoise/noise/pallas_kernels.py`).

* `fused_sap_median_batched`: salt & pepper from a coordinate hash, then a
  3x3 median once or twice (BORDER_REPLICATE; the second pass re-pads from
  the filtered rows).
* `fused_gaussian_blur`: Box-Muller gaussian noise from two coordinate
  hashes, u8 truncation, then a [1,2,1]/4 blur once or twice (REFLECT_101;
  halo rows draw the mirrored row's noise).
* `fused_sap_median`: the per-image entry of the sap + median kernel
  (`pallas_kernels.fused_sap_median`, one `pallas_call` per image): f32
  images, one launch of the same CUDA kernel per image.
* `sap_stages` and `sap_full_padded`: the sap + median kernel cut into
  stages (copy / noise / med1 / full) on a pre-padded raster, the
  counterparts of the profiling forks in `benchmarks/profile_sap_breakdown.py`
  and `benchmarks/profile_fused.py` (kernels of `csrc/sap_stages.cu`).

Images are (B, H, W, 3) uint8 or float32 u8-domain; the output dtype
follows the input.  A CUDA tensor launches the kernel of
`csrc/fused_noise.cu`; a CPU tensor runs the plain version (`*_plain`),
which performs the same per-element arithmetic on whole images.  The plain
versions hash in int64 masked to 32 bits: torch on the CPU lacks uint32
`>>` and `<`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch import cuda_build

_M32 = 0xFFFFFFFF
_INV255 = float(np.float32(1.0 / 255.0))
_INV2_31 = float(np.float32(1.0 / 2147483648.0))
_TWO_PI = float(np.float32(2.0 * 3.14159265358979))
_TINY = float(np.float32(1e-12))
_SEED2 = 0x2545F491

# kernel launches, counted where each wrapper launches its kernel
launches = {'sap_median': 0, 'gauss_blur': 0, 'sap_median_image': 0,
            'sap_stages_f32': 0, 'sap_stages_u8': 0, 'sap_full_padded': 0}

HALO = 4                      # raster rows above global row 0
LANES = 128                   # the raster's width is a multiple of this
STAGES = ('copy', 'noise', 'med1', 'full')


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


def _sap_threshold_i32(amount: float) -> int:
    """The uint32 threshold as the int32 argument of the kernels."""
    t = _sap_threshold(amount)
    return t - 2**32 if t >= 2**31 else t


# ---------------------------------------------------------- stencils ----

def _shift_rows(t: torch.Tensor, mode: str):
    """Rows y-1 and y+1 of (B, H, W3) with a replicate or reflect border."""
    if mode == 'replicate':
        return (torch.cat([t[:, :1], t[:, :-1]], 1),
                torch.cat([t[:, 1:], t[:, -1:]], 1))
    return (torch.cat([t[:, 1:2], t[:, :-1]], 1),
            torch.cat([t[:, 1:], t[:, -2:-1]], 1))


def _median3(t: torch.Tensor, w3: int | None = None,
             pad_rows: bool = True) -> torch.Tensor:
    """3x3 median of (B, R, W3p) in the column-sort form of
    `_median3_tile`; lanes +-3 are a pixel's same-channel neighbours.

    Rows: BORDER_REPLICATE, or with pad_rows False only the R - 2 rows
    whose neighbours the tensor holds.  Lanes: x - 3 replicates where
    x < 3 and x + 3 where x >= w3 - 3 (w3 defaults to the width; lanes
    past it are pad lanes, which take themselves as right neighbour)."""
    w3 = t.shape[-1] if w3 is None else w3
    if pad_rows:
        a, c = _shift_rows(t, 'replicate')
    else:
        a, t, c = t[:, :-2], t[:, 1:-1], t[:, 2:]
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


def _stage_index(stage: str) -> int:
    if stage not in STAGES:
        raise ValueError(f'stage must be one of {STAGES}, got {stage!r}')
    return STAGES.index(stage)


def sap_stages_plain(raster: torch.Tensor, seeds: torch.Tensor, h: int,
                     w3: int, stage: str, amount: float = 0.4
                     ) -> torch.Tensor:
    """The sap + median kernel cut at `stage` on a pre-padded raster
    (B, hp + 8, w3p) -> (B, hp, w3p), in global coordinates: raster row
    g + 4 holds image row g; the hash takes the row clamped to [0, h-1]
    and the lane clamped to w3 - 1; the first median reads the raster's own
    halo rows; the second replaces filtered rows -1 and h by rows 0 and
    h - 1."""
    _stage_index(stage)
    _, rows, w3p = raster.shape
    hp = rows - 2 * HALO
    if stage == 'copy':
        return raster[:, HALO:HALO + hp].clone()
    g = torch.arange(-HALO, rows - HALO, device=raster.device)
    iy = g.clamp(0, h - 1)[None, :, None]
    ix = torch.arange(w3p, device=raster.device).clamp(max=w3 - 1)
    bits = hash2d(iy, ix[None, None, :],
                  (seeds.to(torch.int64) & _M32)[:, None, None])
    flipped = bits < _sap_threshold(amount)
    salted = (bits & 1) == 1
    noisy = torch.where(flipped & salted, 255.0, raster.to(torch.float32))
    noisy = torch.where(flipped & ~salted, 0.0, noisy)
    if stage == 'noise':
        out = noisy[:, HALO:HALO + hp]
    else:
        m1 = _median3(noisy, w3, pad_rows=False)    # rows -3 .. hp + 2
        if stage == 'med1':
            out = m1[:, HALO - 1:HALO - 1 + hp]
        else:
            r = g[1:-1]
            src = torch.where(r == -1, 0, torch.where(r == h, h - 1, r))
            m1 = m1[:, (src - r + torch.arange(len(r), device=r.device))]
            out = _median3(m1, w3, pad_rows=False)[:, HALO - 2:HALO - 2 + hp]
    return out.to(raster.dtype)


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
    if images.device.type == 'cpu':
        return fused_sap_median_plain(images, seeds, amount, double_filter)
    b, h, w, _ = images.shape
    images, seeds = images.contiguous(), seeds.contiguous()
    out = torch.empty_like(images)
    suffix = 'u8' if images.dtype == torch.uint8 else 'f32'
    cuda_build.launch('fused_noise', f'sap_median_{suffix}', images, out,
                      seeds, b, h, 3 * w, _sap_threshold_i32(amount),
                      int(double_filter))
    launches['sap_median'] += 1
    return out


def fused_sap_median(images: torch.Tensor, seeds: torch.Tensor,
                     amount: float = 0.4, double_filter: bool = True
                     ) -> torch.Tensor:
    """Salt & pepper + median3 (x2), one image per launch: images (B, H, W,
    3) float32 u8-domain, seeds (B,) int32.  Equal to
    `fused_sap_median_batched` on the same inputs."""
    _check(images, seeds)
    if images.dtype != torch.float32:
        raise TypeError(f'images must be float32, got {images.dtype}')
    if images.device.type == 'cpu':
        return fused_sap_median_plain(images, seeds, amount, double_filter)
    _, h, w, _ = images.shape
    images, seeds = images.contiguous(), seeds.contiguous()
    out = torch.empty_like(images)
    for i in range(images.shape[0]):
        cuda_build.launch('fused_noise', 'sap_median_f32', images[i:i + 1],
                          out[i:i + 1], seeds[i:i + 1], 1, h, 3 * w,
                          _sap_threshold_i32(amount), int(double_filter))
        launches['sap_median_image'] += 1
    return out


def _check_raster(raster: torch.Tensor, seeds: torch.Tensor, h: int,
                  w3: int):
    if raster.dim() != 3 or raster.dtype not in (torch.uint8, torch.float32):
        raise ValueError('raster must be (B, hp + 8, w3p) uint8 or float32, '
                         f'got {tuple(raster.shape)} {raster.dtype}')
    b, rows, w3p = raster.shape
    if not (0 < h <= rows - 2 * HALO and 3 <= w3 <= w3p):
        raise ValueError(f'h={h}, w3={w3} do not fit a raster of {rows} rows '
                         f'and {w3p} lanes')
    if seeds.shape != (b,) or seeds.dtype != torch.int32:
        raise ValueError('seeds must be (B,) int32')
    if seeds.device != raster.device:
        raise ValueError('seeds and raster must share a device')
    if raster.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {raster.device}')


def sap_stages(raster: torch.Tensor, seeds: torch.Tensor, h: int, w3: int,
               stage: str, amount: float = 0.4, counter: str | None = None
               ) -> torch.Tensor:
    """The sap + median kernel cut at `stage` ('copy', 'noise', 'med1' or
    'full') on a pre-padded (B, hp + 8, w3p) uint8 or float32 raster of an
    image of h rows and w3 lanes; returns (B, hp, w3p) of the raster's
    dtype (see `sap_stages_plain`).  A launch counts under `counter`
    (default: the entry's name)."""
    _check_raster(raster, seeds, h, w3)
    idx = _stage_index(stage)
    if raster.device.type == 'cpu':
        return sap_stages_plain(raster, seeds, h, w3, stage, amount)
    entry = ('sap_stages_u8' if raster.dtype == torch.uint8
             else 'sap_stages_f32')
    b, rows, w3p = raster.shape
    raster, seeds = raster.contiguous(), seeds.contiguous()
    out = torch.empty((b, rows - 2 * HALO, w3p), dtype=raster.dtype,
                      device=raster.device)
    cuda_build.launch('sap_stages', entry, raster, out, seeds, b, h, w3,
                      rows - 2 * HALO, w3p, idx, _sap_threshold_i32(amount))
    launches[counter or entry] += 1
    return out


def sap_full_padded(raster: torch.Tensor, seeds: torch.Tensor, h: int,
                    w3: int, amount: float = 0.4) -> torch.Tensor:
    """Salt & pepper + median3 x2 on a pre-padded float32 raster, pad rows
    and pad lanes computed from whatever the raster holds there: the
    kernel of `fused_sap_median_batched` without its padding and slicing,
    i.e. the f32 full stage, counted as 'sap_full_padded'."""
    if raster.dtype != torch.float32:
        raise TypeError(f'raster must be float32, got {raster.dtype}')
    return sap_stages(raster, seeds, h, w3, 'full', amount,
                      counter='sap_full_padded')


def fused_gaussian_blur(images: torch.Tensor, seeds: torch.Tensor,
                        var: float = 0.1, double_filter: bool = True,
                        sigmas: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian noise + GaussianBlur3 (x2) over a batch; seeds (B,) int32,
    sigmas optional (B,) per-image std overriding `var`."""
    _check(images, seeds)
    if sigmas is not None and (sigmas.shape != (images.shape[0],)
                               or sigmas.device != images.device):
        raise ValueError('sigmas must be (B,) on the images device')
    if images.device.type == 'cpu':
        return fused_gaussian_blur_plain(images, seeds, var, double_filter,
                                         sigmas)
    b, h, w, _ = images.shape
    if h < 2 or w < 2:
        raise ValueError('REFLECT_101 needs H >= 2 and W >= 2')
    apply = _sigmas(b, var, sigmas, images.device)
    sig = (apply if apply is not None
           else torch.zeros(b, dtype=torch.float32, device=images.device))
    images, seeds = images.contiguous(), seeds.contiguous()
    out = torch.empty_like(images)
    suffix = 'u8' if images.dtype == torch.uint8 else 'f32'
    cuda_build.launch('fused_noise', f'gauss_blur_{suffix}', images, out,
                      seeds, sig.contiguous(), b, h, 3 * w,
                      int(apply is not None), int(double_filter))
    launches['gauss_blur'] += 1
    return out
