"""Curvelet-frame denoising on `torch.fft` (counterpart of
`tpudenoise/denoise/curvelet.py`).

A tight frame built in the 2-D FFT domain: `nbscales` dyadic radial bands,
all but the lowpass split into angular wedges, with squared-cosine
windows whose squares sum to 1 (`_wedge_windows`, numpy, the reference's
code, cached per shape: 29 bands at nbscales 4, nbangles 16).  Per
channel: analysis (FFT, window, inverse FFT per band), a global threshold
at the `1 - keep` quantile of all the bands' coefficient magnitudes, the
coefficients under it dropped, synthesis (FFT, window again, sum, inverse
FFT), then `saturate_u8(255 * y)`.  Below 32 px a side the wedges
degenerate and the image's own FFT is thresholded per channel.

`torch.quantile` refuses more than 2^24 elements, and one channel at
600x1000 has 17.4M magnitudes, so `quantile_linear` takes `jnp.quantile`'s
default linear interpolation from two order statistics, with the index
computed in float32 as the reference computes it.  The FFTs run in
complex64 with the windows in float32, as the reference's.  A batch runs
4 images at a time (`curvelet_denoise_batched`), as the reference's
`lax.map` over 4-image chunks: 29 complex64 bands of one channel at
608x1024 are 144 MB.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudenoise_torch.noise.generators import saturate_u8, to_unit

CHUNK = 4          # images a pass of the batched denoiser
_F32 = np.float32


@functools.lru_cache(maxsize=8)
def _wedge_windows(h: int, w: int, nbscales: int, nbangles: int):
    """The squared-cosine partition-of-unity windows: (n_bands, h, w)
    float32 with sum(win^2) == 1 (the reference's numpy, unchanged)."""
    fy = np.fft.fftfreq(h)[:, None]          # [-0.5, 0.5)
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy * fy + fx * fx) / 0.5     # radius normalized to [0, ~1.4]
    theta = np.arctan2(fy, fx)               # [-pi, pi]

    # radial partition: lowpass + (nbscales-1) dyadic annuli; squared-cos
    # crossfades so sum of squares = 1
    edges = [0.5 ** (nbscales - s) for s in range(1, nbscales)] + [2.0]

    def rise(x):  # smooth 0->1 on [0,1]
        x = np.clip(x, 0.0, 1.0)
        return np.sin(0.5 * np.pi * x)

    radial = []
    prev_edge = 0.0
    for si, edge in enumerate(edges):
        lo = prev_edge
        hi = edge
        if si == 0:
            up = 1.0 - rise((r - 0.5 * hi) / (0.5 * hi)) ** 2
            band = np.sqrt(np.clip(up, 0, 1))
        else:
            up = rise((r - 0.5 * lo) / (0.5 * lo)) ** 2
            if si < len(edges) - 1:
                down = 1.0 - rise((r - 0.5 * hi) / (0.5 * hi)) ** 2
                band = np.sqrt(np.clip(up * down, 0, 1))
            else:
                band = np.sqrt(np.clip(up, 0, 1))
        radial.append(band)
        prev_edge = edge
    # enforce exact partition of unity radially
    norm = np.sqrt(np.sum([b * b for b in radial], axis=0))
    radial = [b / np.maximum(norm, 1e-12) for b in radial]

    # angular wedges (applied to all but the lowpass band); squared-cos
    # overlapping bumps over 2*pi with sum of squares = 1
    windows = [radial[0]]
    for si, band in enumerate(radial[1:], start=1):
        n_ang = max(nbangles // (2 ** (len(radial) - 1 - si)), 4)
        width = 2 * np.pi / n_ang
        ang_sum = np.zeros((h, w))
        bumps = []
        for a in range(n_ang):
            center = -np.pi + (a + 0.5) * width
            d = np.angle(np.exp(1j * (theta - center)))
            bump = np.cos(0.5 * np.pi * np.clip(np.abs(d) / width, 0, 1))
            bumps.append(bump)
            ang_sum += bump * bump
        ang_norm = np.sqrt(np.maximum(ang_sum, 1e-12))
        for bump in bumps:
            windows.append(band * bump / ang_norm)
    return np.stack(windows).astype(np.float32)


_DEVICE_WINDOWS: dict = {}


def _windows(h: int, w: int, nbscales: int, nbangles: int, device
             ) -> torch.Tensor:
    """`_wedge_windows` as a float32 tensor on `device`, kept per shape
    and device (the last 4)."""
    key = (h, w, nbscales, nbangles, str(device))
    if key not in _DEVICE_WINDOWS:
        if len(_DEVICE_WINDOWS) >= 4:
            _DEVICE_WINDOWS.pop(next(iter(_DEVICE_WINDOWS)))
        _DEVICE_WINDOWS[key] = torch.from_numpy(
            _wedge_windows(h, w, nbscales, nbangles)).to(device)
    return _DEVICE_WINDOWS[key]


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (0-based) value of each row of (R, N)
    non-negative float32, exactly: such floats order as their int32 bit
    patterns, so the answer's 31 bits are found from the top, a bit a
    step, each step one compare-and-count over the rows (the largest t
    with at most k values below it).  31 passes over the data and no
    wait on the device; `torch.kthvalue` on the card runs one block a
    row and took 91% of the post-pass (`benchmarks/profile_curvelet.py`
    on an H100; PERF.md section 6)."""
    bits = x.contiguous().view(torch.int32)
    ans = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for b in range(30, -1, -1):
        cand = ans | (1 << b)
        below = (bits < cand[:, None]).sum(1)
        ans = torch.where(below <= k, cand, ans)
    return ans.view(torch.float32)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(row, q)` (method 'linear') of each row of (R, N)
    non-negative float32 (the magnitudes): the index q * (N - 1) in
    float32 (so above 2^24 it rounds as the reference's does), then the
    two order statistics around it weighted by its fraction.  The lower
    one by `kth_smallest`, the upper one as the least value above it
    unless the lower one repeats."""
    n = x.shape[-1]
    qi = _F32(q) * (_F32(n) - _F32(1.0))
    low, high = np.floor(qi), np.ceil(qi)
    w_hi = qi - low
    w_lo = _F32(1.0) - w_hi
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    lo = kth_smallest(x, lo_i)
    if hi_i == lo_i:
        hi = lo
    else:      # hi_i == lo_i + 1
        repeats = (x <= lo[:, None]).sum(-1) > lo_i + 1
        above = torch.where(x > lo[:, None], x, float('inf')).amin(-1)
        hi = torch.where(repeats, lo, above)
    return lo * float(w_lo) + hi * float(w_hi)


def _frame_denoise(x: torch.Tensor, wins: torch.Tensor, keep: float
                   ) -> torch.Tensor:
    """(P, H, W) float32 planes: analysis into the wedge bands, each
    plane's threshold at the `1 - keep` quantile of its bands'
    magnitudes, synthesis."""
    coeffs = torch.fft.ifft2(wins * torch.fft.fft2(x)[:, None])
    mag = coeffs.abs()
    thresh = quantile_linear(mag.reshape(mag.shape[0], -1), 1.0 - keep)
    kept = torch.where(mag >= thresh[:, None, None, None], coeffs, 0.0)
    del coeffs, mag
    syn = (wins * torch.fft.fft2(kept)).sum(1)
    return torch.fft.ifft2(syn).real


def _fft_denoise(x: torch.Tensor, keep: float) -> torch.Tensor:
    """The small-image fallback over (P, H, W) planes: each plane's FFT,
    thresholded at the `1 - keep` quantile of its own magnitudes."""
    f = torch.fft.fft2(x)
    mag = f.abs()
    thresh = quantile_linear(mag.reshape(mag.shape[0], -1), 1.0 - keep)
    f = torch.where(mag >= thresh[:, None, None], f, 0.0)
    return torch.fft.ifft2(f).real


def curvelet_denoise_batched(images: torch.Tensor, keep: float = 0.5,
                             nbscales: int = 4, nbangles: int = 16
                             ) -> torch.Tensor:
    """Wedge-frame denoise of (B, H, W, 3) u8-domain images, CHUNK at a
    time: keep the top `keep` fraction of each channel's coefficients by
    magnitude, reconstruct, saturate to u8; float32 out."""
    b, h, w, _ = images.shape
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=images.device)
    wins = (None if min(h, w) < 32
            else _windows(h, w, nbscales, nbangles, images.device))
    for i in range(0, b, CHUNK):
        x = to_unit(images[i:i + CHUNK].to(torch.float32))
        planes = x.permute(0, 3, 1, 2).reshape(-1, h, w)
        y = (_fft_denoise(planes, keep) if wins is None
             else _frame_denoise(planes, wins, keep))
        out[i:i + CHUNK] = saturate_u8(
            255.0 * y.reshape(-1, 3, h, w).permute(0, 2, 3, 1))
    return out


def curvelet_denoise_u8(img: torch.Tensor, keep: float = 0.5,
                        nbscales: int = 4, nbangles: int = 16
                        ) -> torch.Tensor:
    """One (H, W, 3) u8-domain image (`curvelet_denoise_batched`)."""
    return curvelet_denoise_batched(img[None], keep, nbscales, nbangles)[0]
