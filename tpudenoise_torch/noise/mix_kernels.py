"""Fused mixed-noise kernels (counterpart of `tpudenoise/noise/pallas_mix.py`
`fused_mix_noise` and `fused_mix_bilateral`).

Each image runs the one generator its prologue drew (`mix_prologue.py`):
original, gaussian, poisson, sap, speckle, quant, uniform, brownian,
periodic, gamma, rayleigh, bloom or shader.  Random draws come from a
counter hash of the element raster index (y*w + x)*3 + c, salted per
draw and seeded by the image's two seed words, so every element's noise
is fixed whatever the tiling.  Output float32 in the reference's domains:
gaussian in [0, 1] (a reference quirk), every other kind u8-domain.
`fused_mix_bilateral` adds the d=9 bilateral of the noisy image
(BORDER_CONSTANT), with nothing noisy written to device memory.

A CUDA tensor launches the kernels of `csrc/mix_noise.cu`; a CPU tensor
runs the plain versions (`*_plain`), the same per-element arithmetic on
whole images, hashing in int64 masked to 32 bits.

Brownian noise is the exclusive prefix sum of sqrt(level) * N(0, 1) over
the image's element raster (1.8M terms at 600x1000).  Its f32 rounding
grows like sqrt(n) ulps, so two summation orders give visibly different
u8 images; both versions therefore fix one order: each raster row is
scanned in log steps (Hillis-Steele: x[i] += x[i-k] for k = 1, 2, 4, ...),
then the row totals are scanned the same way over the rows, and an
element's path is its row's exclusive offset plus its exclusive in-row
prefix.  The reference's order (a lane scan carried across row tiles) is
another, so against it brownian agrees only up to those roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.denoise.bilateral import (bilateral_plain,
                                                color_coeff, taps)
from tpudenoise_torch.noise.fused_kernels import _M32, _mul32
from tpudenoise_torch.noise.generators import (N_STEPS, bloom_apply_scan,
                                               brownian_path, saturate_u8,
                                               wrap_cast_u8)
from tpudenoise_torch.noise.kmeans import K_PAD
from tpudenoise_torch.noise.spec import Kind

# kernel launches, counted where each wrapper launches its kernels
launches = {'mix_noise': 0, 'mix_bilateral': 0}


def _f32(x: float) -> float:
    return float(np.float32(x))


_INV255 = _f32(1.0 / 255.0)
_TWO_PI = _f32(2.0 * np.pi)
_GAMMA_A = 1.99
_GAMMA_D = _f32(_GAMMA_A - 1.0 / 3.0)
_GAMMA_C = _f32(1.0 / np.sqrt(9.0 * (_GAMMA_A - 1.0 / 3.0)))


# ------------------------------------------------------------- hashing --

def hash_ctr(ctr: torch.Tensor, salt: int, s0: int, s1: int
             ) -> torch.Tensor:
    """`pallas_mix._hash_ctr` on an int64 tensor of uint32 counters and
    the two seed words (ints in [0, 2**32)); returns int64 in
    [0, 2**32)."""
    h = (_mul32(ctr, 0x9E3779B9) ^ ((salt * 0x85EBCA6B) & _M32)
         ^ ((s0 * 0xC2B2AE35) & _M32))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ ((s1 * 0x27D4EB2F) & _M32)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def u01_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform in (0, 1) from the top 24 hash bits, half an ulp off 0."""
    return ((bits >> 8).to(torch.float32) + 0.5) * _f32(2.0 ** -24)


class _Image:
    """One image's element grid (H, W, 3) and its per-image scalars."""

    def __init__(self, x, level, vals, seeds, centers, bloom):
        h, w, _ = x.shape
        dev = x.device
        self.x, self.h, self.w = x, h, w
        iy = torch.arange(h, device=dev)[:, None, None]
        ix = torch.arange(w, device=dev)[None, :, None]
        self.ctr = (iy * w + ix) * 3 + torch.arange(3, device=dev)
        self.level = level                    # 0-d float32 tensors
        self.vals = vals
        s = seeds.tolist()
        self.s0, self.s1 = s[0] & _M32, s[1] & _M32
        self.centers = centers.tolist()       # float32 values
        self.bloom = bloom
        self.x01 = x * _INV255

    def bits(self, salt):
        return hash_ctr(self.ctr, salt, self.s0, self.s1)

    def u01(self, salt):
        return u01_bits(self.bits(salt))

    def normal(self, salt):
        u1, u2 = self.u01(salt), self.u01(salt + 1)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


# ---------------------------------------------------------- kind bodies --

def _original(g):
    return g.x


def _gaussian(g):
    z = g.normal(64)
    return torch.clamp(g.x01 + z * torch.sqrt(g.level), 0.0, 1.0)


def _sap(g):
    bits = g.bits(70)
    flipped = u01_bits(bits) < g.level
    salted = (bits & 1) == 1
    out = torch.where(flipped & salted, 255.0, g.x)
    return torch.where(flipped & ~salted, 0.0, out)


def _speckle(g):
    z = g.normal(66)
    out = torch.clamp(g.x01 + g.x01 * z * torch.sqrt(g.level), 0.0, 1.0)
    return wrap_cast_u8(255.0 * out)


def _uniform(g):
    return wrap_cast_u8(255.0 * (g.x01 + g.u01(68) * g.level))


def _rayleigh(g):
    u = g.u01(69)
    return wrap_cast_u8(255.0 * (g.x01 + g.level
                                 * torch.sqrt(-2.0 * torch.log(u))))


def _gamma(g):
    """Marsaglia-Tsang, a = 1.99, four fixed rounds."""
    d, c = _GAMMA_D, _GAMMA_C
    out = torch.zeros_like(g.x)
    last = torch.full_like(g.x, d)
    ok = torch.zeros_like(g.x, dtype=torch.bool)
    for r in range(4):
        x = g.normal(32 + 3 * r)
        u = g.u01(34 + 3 * r)
        t = 1.0 + c * x
        v = t * (t * t)
        pos = v > 0.0
        vs = torch.where(pos, v, 1.0)
        accept = pos & (torch.log(u) < 0.5 * x * x
                        + d * (1.0 - vs + torch.log(vs)))
        cand = d * vs
        out = torch.where(accept & ~ok, cand, out)
        ok = ok | accept
        last = torch.where(pos, cand, last)
    gam = torch.where(ok, out, last)
    return wrap_cast_u8(255.0 * (g.x01 + gam * g.level))


def _stirling_lgamma(z):
    t = z + 8.0
    inv = 1.0 / t
    pr = z * inv
    for i in range(1, 8):
        pr = pr * ((z + float(i)) * inv)
    pr = torch.clamp(pr, min=_f32(1e-30))
    inv2 = inv * inv
    series = inv * (_f32(1.0 / 12.0) - inv2 * _f32(1.0 / 360.0))
    return ((t - 8.5) * torch.log(t) - t
            + _f32(0.91893853320467274178) + series - torch.log(pr))


def _poisson(g):
    """Inverse CDF for lam < 10 (33 steps), Hoermann PTRS above (4
    rounds, Stirling lgamma), rounded-normal fallback."""
    vals = g.vals
    lam = g.x01 * vals
    small = lam < 10.0
    u = g.u01(1)
    lam_s = torch.clamp(lam, max=10.0)
    prob = torch.exp(-lam_s)
    cdf = prob
    k_small = torch.zeros_like(lam)
    for n in range(1, 34):
        k_small = torch.where(u > cdf, float(n), k_small)
        prob = prob * lam_s * _f32(1.0 / n)
        cdf = cdf + prob

    lam_b = torch.clamp(lam, min=10.0)
    b = _f32(0.931) + _f32(2.53) * torch.sqrt(lam_b)
    a = _f32(-0.059) + _f32(0.02483) * b
    inv_alpha = _f32(1.1239) + _f32(1.1328) / (b - _f32(3.4))
    v_r = _f32(0.9277) - _f32(3.6224) / (b - 2.0)
    log_lam = torch.log(lam_b)
    k_big = torch.zeros_like(lam)
    ok = torch.zeros_like(lam, dtype=torch.bool)
    for r in range(4):
        w = g.bits(16 + r)
        uu = ((w >> 16).to(torch.float32) + 0.5) * _f32(2.0 ** -16) - 0.5
        vv = ((w & 0xFFFF).to(torch.float32) + 0.5) * _f32(2.0 ** -16)
        us = 0.5 - uu.abs()
        cand = torch.floor((2.0 * a / us + b) * uu + lam_b + _f32(0.43))
        accept = (us >= _f32(0.07)) & (vv <= v_r)
        safe = (cand >= 0.0) & ((us >= _f32(0.013)) | (vv <= us))
        lhs = torch.log(vv * inv_alpha / (a / (us * us) + b))
        rhs = -lam_b + cand * log_lam - _stirling_lgamma(cand + 1.0)
        accept = accept | (safe & (lhs <= rhs))
        k_big = torch.where(accept & ~ok, cand, k_big)
        ok = ok | accept
    z = g.normal(8)
    fallback = torch.clamp(torch.round(lam_b + torch.sqrt(lam_b) * z),
                           min=0.0)
    k_big = torch.where(ok, k_big, fallback)
    k = torch.where(small, k_small, k_big)
    return wrap_cast_u8(255.0 * torch.clamp(k / vals, 0.0, 1.0))


def _periodic(g):
    n = torch.tensor(float(g.h * g.w * 3), dtype=torch.float32,
                     device=g.x.device)
    amp = torch.where(g.level < 0, n, g.level)
    t = -amp + g.ctr.to(torch.float32) * (2.0 * amp / (n - 1.0))
    return saturate_u8(g.x + wrap_cast_u8(torch.sin(t) * 255.0))


def _shader(g):
    bright = saturate_u8(g.x * 3.0)
    return bright.flip(-1)


def _brownian(g):
    z = g.normal(72) * torch.sqrt(g.level)
    path = brownian_path(z.reshape(g.h, g.w * 3)).reshape(g.x.shape)
    return saturate_u8(g.x + wrap_cast_u8(path * 255.0))


def _quant(g):
    """Nearest of the K_PAD prologue centres in u8 LAB, taken with the
    kernel's inlined LAB (exp/log powers); output the centre's BGR."""
    def lin(v):
        v = v * _INV255
        p = torch.exp(torch.log(torch.clamp(
            (v + _f32(0.055)) * _f32(1.0 / 1.055), min=_f32(1e-12)))
            * _f32(2.4))
        return torch.where(v > _f32(0.04045), p, v * _f32(1.0 / 12.92))

    def cbrt_pos(t):
        return torch.exp(torch.log(torch.clamp(t, min=_f32(1e-30)))
                         * _f32(1.0 / 3.0))

    def flab(t):
        return torch.where(t > _f32(0.008856), cbrt_pos(t),
                           _f32(7.787) * t + _f32(16.0 / 116.0))

    lb, lg, lr = (lin(g.x[..., c]) for c in range(3))
    x = ((_f32(0.412453) * lr + _f32(0.357580) * lg)
         + _f32(0.180423) * lb) * _f32(1.0 / 0.950456)
    y = (_f32(0.212671) * lr + _f32(0.715160) * lg) + _f32(0.072169) * lb
    zc = ((_f32(0.019334) * lr + _f32(0.119193) * lg)
          + _f32(0.950227) * lb) * _f32(1.0 / 1.088754)
    lv = torch.where(y > _f32(0.008856), 116.0 * cbrt_pos(y) - 16.0,
                     _f32(903.3) * y)
    fx, fy, fz = flab(x), flab(y), flab(zc)
    l8 = torch.clamp(torch.round(lv * _f32(255.0 / 100.0)), 0.0, 255.0)
    a8 = torch.clamp(torch.round(500.0 * (fx - fy) + 128.0), 0.0, 255.0)
    b8 = torch.clamp(torch.round(200.0 * (fy - fz) + 128.0), 0.0, 255.0)
    best = torch.full_like(l8, 1e30)
    out = torch.zeros_like(g.x)
    c = g.centers
    for k in range(K_PAD):
        dl, da, db = l8 - c[6 * k], a8 - c[6 * k + 1], b8 - c[6 * k + 2]
        d = (dl * dl + da * da) + db * db
        better = d < best
        best = torch.where(better, d, best)
        out = torch.where(better[..., None],
                          torch.tensor(c[6 * k + 3:6 * k + 6],
                                       dtype=torch.float32,
                                       device=out.device), out)
    return out


def _bloom(g):
    return bloom_apply_scan(g.x[None], g.bloom[None])[0]


_BODIES = {
    Kind.ORIGINAL: _original, Kind.GAUSSIAN: _gaussian,
    Kind.POISSON: _poisson, Kind.SAP: _sap, Kind.SPECKLE: _speckle,
    Kind.QUANT: _quant, Kind.UNIFORM: _uniform, Kind.BROWNIAN: _brownian,
    Kind.PERIODIC: _periodic, Kind.GAMMA: _gamma,
    Kind.RAYLEIGH: _rayleigh, Kind.BLOOM: _bloom, Kind.SHADER: _shader,
}


# ------------------------------------------------------ plain versions --

def fused_mix_noise_plain(images, branch, level, seeds, vals, centers,
                          bloom, kinds) -> torch.Tensor:
    x = images.to(torch.float32)
    out = torch.empty_like(x)
    for i, pos in enumerate(branch.tolist()):
        g = _Image(x[i], level[i].to(torch.float32),
                   vals[i].to(torch.float32), seeds[i], centers[i],
                   bloom[i].to(torch.float32))
        out[i] = _BODIES[Kind(kinds[pos])](g)
    return out


def fused_mix_bilateral_plain(images, branch, level, seeds, vals, centers,
                              bloom, kinds, sigma_color: float = 20.0,
                              sigma_space: float = 100.0) -> torch.Tensor:
    noisy = fused_mix_noise_plain(images, branch, level, seeds, vals,
                                  centers, bloom, kinds)
    return bilateral_plain(noisy, sigma_color, sigma_space)


# ------------------------------------------------------------ wrappers --

def _check(images, branch, level, seeds, vals, centers, bloom, kinds):
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f'images must be (B, H, W, 3), got {images.shape}')
    if images.dtype != torch.uint8:
        raise TypeError(f'images must be uint8, got {images.dtype}')
    if images.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {images.device}')
    b = images.shape[0]
    want = {'branch': (branch, (b,), torch.int32),
            'level': (level, (b,), torch.float32),
            'seeds': (seeds, (b, 2), torch.int32),
            'vals': (vals, (b,), torch.float32),
            'centers': (centers, (b, K_PAD * 6), torch.float32),
            'bloom': (bloom, (b, N_STEPS, 8), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != images.device):
            raise ValueError(f'{name} must be {shape} {dtype} on the images '
                             f'device')
    if not kinds or any(int(k) not in _BODIES for k in kinds):
        raise ValueError(f'unknown kinds {kinds}')
    _, h, w, _ = images.shape
    if h * w * 3 >= 2**31:
        raise ValueError('the element raster index must fit in int32')
    if int(Kind.BROWNIAN) in kinds and 8 * max(3 * w, h) > 232448:
        raise ValueError('brownian scans a row (and the row totals) in '
                         'shared memory: 3W and H must be <= 29056')


def _launch_args(images, branch, level, seeds, vals, centers, bloom, kinds):
    """Contiguous kernel operands; brownian-drawn images get their row
    scans and row offsets from the prefix pass first."""
    b, h, w, _ = images.shape
    dev = images.device
    kind = torch.tensor([int(k) for k in kinds], dtype=torch.int32,
                        device=dev)[branch.to(torch.int64)]
    level, seeds = level.contiguous(), seeds.contiguous()
    if int(Kind.BROWNIAN) in kinds:
        rows = torch.empty((b, h, 3 * w), dtype=torch.float32, device=dev)
        tot = torch.empty((b, h), dtype=torch.float32, device=dev)
        off = torch.empty((b, h), dtype=torch.float32, device=dev)
        cuda_build.launch('mix_noise', 'brownian_prefix', kind, level, seeds,
                          rows, tot, off, b, h, 3 * w)
    else:
        rows = off = torch.zeros(1, dtype=torch.float32, device=dev)
    return (images.contiguous(), kind, level, seeds, vals.contiguous(),
            centers.contiguous(), bloom.contiguous(), rows, off)


def fused_mix_noise(images, branch, level, seeds, vals, centers, bloom,
                    kinds) -> torch.Tensor:
    """Per-image mixed noise: images (B, H, W, 3) uint8; branch (B,) int32
    position into `kinds` (the plan's Kind values, sorted); level, vals
    (B,) f32; seeds (B, 2) int32; centers (B, 60) f32; bloom (B, 48, 8)
    f32.  Returns (B, H, W, 3) float32."""
    _check(images, branch, level, seeds, vals, centers, bloom, kinds)
    if images.device.type == 'cpu':
        return fused_mix_noise_plain(images, branch, level, seeds, vals,
                                     centers, bloom, kinds)
    b, h, w, _ = images.shape
    (im, kind, level, seeds, vals, centers, bloom, rows,
     off) = _launch_args(images, branch, level, seeds, vals, centers,
                         bloom, kinds)
    out = torch.empty(images.shape, dtype=torch.float32,
                      device=images.device)
    cuda_build.launch('mix_noise', 'mix_noise', im, out, kind, level, seeds,
                      vals, centers, bloom, rows, off, b, h, w)
    launches['mix_noise'] += 1
    return out


def fused_mix_bilateral(images, branch, level, seeds, vals, centers, bloom,
                        kinds, sigma_color: float = 20.0,
                        sigma_space: float = 100.0) -> torch.Tensor:
    """`fused_mix_noise` followed by the d=9 bilateral of the noisy image,
    in one pass.  Returns (B, H, W, 3) float32."""
    _check(images, branch, level, seeds, vals, centers, bloom, kinds)
    if images.device.type == 'cpu':
        return fused_mix_bilateral_plain(images, branch, level, seeds, vals,
                                         centers, bloom, kinds, sigma_color,
                                         sigma_space)
    b, h, w, _ = images.shape
    (im, kind, level, seeds, vals, centers, bloom, rows,
     off) = _launch_args(images, branch, level, seeds, vals, centers,
                         bloom, kinds)
    sw = torch.tensor([t[2] for t in taps(sigma_space)], dtype=torch.float32,
                      device=images.device)
    out = torch.empty(images.shape, dtype=torch.float32,
                      device=images.device)
    cuda_build.launch('mix_noise', 'mix_bilateral', im, out, kind, level,
                      seeds, vals, centers, bloom, rows, off, sw,
                      color_coeff(sigma_color), b, h, w)
    launches['mix_bilateral'] += 1
    return out
