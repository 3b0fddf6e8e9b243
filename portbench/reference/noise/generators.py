# Frozen copy of tpudenoise_torch/noise/generators.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""The noise generators that the benchmark's noise strings reach
(counterpart of `tpudenoise/noise/generators.py`).

* `wrap_cast_u8` / `saturate_u8`: numpy's float -> uint8 cast (truncate,
  wrap mod 256) and cv2's saturate_cast (round half-even, clamp).
* `u8_unique_count`: the distinct u8 values of an image (skimage's
  poisson quantizer), on the image's device.
* `bloom_params`: the (48, 8) sun-flare compositing steps per key, drawn
  in numpy from the threefry port (`prng`) with the float32 arithmetic
  of the reference, so the values are bit-equal; `bloom_apply_scan`
  composites them over a batch.
* `log_step_scan` / `brownian_path`: the brownian raster's fixed
  summation order.
* the threefry generators of the single-kind route: `to_unit`,
  `gaussian`, `speckle` and `periodic`, batched over images with one key
  each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.noise import prng

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
    return _bloom_params(key, w, h, w)


def _bloom_params(key, w: int, vh: int, vw: int) -> np.ndarray:
    f32 = np.float32
    fc = f32(100.0)
    angle = (-math.pi / 4) % (2 * math.pi)
    n_line = (w + 9) // 10
    line_x = np.arange(n_line, dtype=f32) * f32(10.0)
    line_y = f32(200.0) - (f32(math.tan(angle)) * (line_x - fc) + fc)
    rad_hi = max(vh // 100 - 2, 1)
    k = prng.split(prng.split(key, N_CIRC), 4)          # (..., 8, 4, 2)
    r_idx = prng.randint(k[..., 1, :], (), 0, (vw + 9) // 10)
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


# ----------------------------------------------- threefry generators --
#
# The reference's XLA generators (`tpudenoise/noise/generators.py`), batched
# over (B, H, W, 3) u8-domain float32 images with one key per image ((B, 2)
# uint32): each draws its fields with `prng.draw_*` on the images' device
# and does the rest in torch ops, rounding where XLA's CPU code rounds.
# Inside the reference's program XLA folds constant factors into the
# normal draws' sqrt(2) (`normal * sd` is erf_inv * (sqrt(2) * sd), even
# for a per-image sd) and contracts a multiply feeding an add into one FMA,
# to_unit's `img * (1/255)` included; `prng._fma_t` rounds once where it
# does.  The tests hold each form bit-equal on the floats.

_INV255 = float(np.float32(1.0 / 255.0))


def to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """img_as_float for u8-domain floats: x * f32(1/255)."""
    return img_u8 * _INV255


def _unit_plus(img_u8: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """to_unit(img) + t with to_unit's multiply contracted into the add."""
    return prng._fma_t(img_u8, _INV255, t)


def _n(x: torch.Tensor) -> int:
    return x[0].numel()


def gaussian(keys, img_u8: torch.Tensor, var) -> torch.Tensor:
    """x + N(0, var), clipped to [0, 1]; var a float or a (B,) float32
    tensor (the per-image level of the randomized-level quirk)."""
    n, dev = _n(img_u8), img_u8.device
    if isinstance(var, torch.Tensor):
        factor = torch.sqrt(var.to(torch.float32)) * float(prng._SQRT2)
        noise = prng.draw_erf_inv(keys, n, dev) * factor[:, None]
    else:
        noise = prng.draw_normal(keys, n, dev, np.sqrt(np.float32(var)))
    return torch.clamp(_unit_plus(img_u8, noise.reshape(img_u8.shape)),
                       0.0, 1.0)


def speckle(keys, img_u8: torch.Tensor, var: float) -> torch.Tensor:
    """x + x * N(0, var), clipped to [0, 1]."""
    n, dev = _n(img_u8), img_u8.device
    sd = np.sqrt(np.float32(var))
    noise = prng.draw_normal(keys, n, dev, sd).reshape(img_u8.shape)
    x01 = to_unit(img_u8)
    return torch.clamp(prng._fma_t(x01, noise, x01), 0.0, 1.0)


def log_step_scan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along `dim` in the fixed Hillis-Steele order
    of the brownian kernels: x[i] += x[i - k] for k = 1, 2, 4, ..."""
    n = x.shape[dim]
    k = 1
    while k < n:
        x = torch.cat([x.narrow(dim, 0, k),
                       x.narrow(dim, k, n - k) + x.narrow(dim, 0, n - k)],
                      dim)
        k *= 2
    return x


def brownian_path(z: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of the (H, W*3) raster increments z, rows first:
    an element's row offset plus its exclusive in-row prefix."""
    rows = log_step_scan(z, 1)
    excl = torch.cat([torch.zeros_like(rows[:, :1]), rows[:, :-1]], 1)
    tot = log_step_scan(rows[:, -1], 0)
    off = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
    return off[:, None] + excl


def periodic(img_u8: torch.Tensor, amplitude: float) -> torch.Tensor:
    """sin over linspace(-A, A, n) of the element raster, times 255,
    wrap-cast, saturating add; amplitude < 0 means A = n.  XLA turns the
    step's division by the constant n - 1 into a multiply by its f32
    reciprocal and contracts -A + i * step."""
    f32 = np.float32
    n = _n(img_u8)
    a = f32(n if amplitude < 0 else amplitude)
    step = float((f32(2.0) * a) * (f32(1.0) / f32(n - 1)))
    i = torch.arange(n, dtype=torch.float32, device=img_u8.device)
    t = prng._fma_t(i, step, float(-a))
    noise = wrap_cast_u8(torch.sin(t) * 255.0).reshape(img_u8.shape[1:])
    return saturate_u8(img_u8 + noise)
