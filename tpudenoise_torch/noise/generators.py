"""The noise generators (counterpart of `tpudenoise/noise/generators.py`).

* `wrap_cast_u8` / `saturate_u8`: numpy's float -> uint8 cast (truncate,
  wrap mod 256) and cv2's saturate_cast (round half-even, clamp).
* `u8_unique_count`: the distinct u8 values of an image (skimage's
  poisson quantizer), on the image's device.
* `bloom_params`: the (48, 8) sun-flare compositing steps per key (with
  `hw`, per image valid extents of a padded canvas), drawn in numpy
  from the threefry port (`core.prng`) with the float32 arithmetic of the
  reference, so the values are bit-equal.
* `bloom_apply_scan`: the 48-step compositing over a batch, the plain
  version of the bloom kernel (`noise/bloom.py`).
* the threefry generators of the single-kind route: `to_unit`,
  `gaussian`, `salt_and_pepper`, `speckle`, `uniform_add`, `gamma_add`,
  `rayleigh_add`, `poisson`, `brownian`, `periodic` and `shader`,
  batched over images with one key each; `brownian` and `periodic` take
  `hw`, each image's valid (h, w) on a bucket-padded canvas (host ints,
  so no shape or loop waits on the device).
* `fast_bits=True` (`--fast-rng`): each stochastic generator draws from
  the counter hash (`prng.draw_hash`) in place of threefry, salts as the
  reference's registry (`generators.py:52-60`): poisson 1/8/16-19, gamma
  32-43 (`samplers.py`), gaussian 64-65, speckle 66-67, uniform 68,
  rayleigh 69, s&p 70-71, brownian 72-73, so that no two draws of one
  key share a (salt, counter) pair.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import samplers

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


def bloom_params(key, h: int, w: int, hw=None) -> np.ndarray:
    """(..., 48, 8) float32 rows (cx, cy, r^2, b, g, r, alpha, 0) of the
    Automold sun flare at flare centre (100, 100), angle -pi/4, for one
    key (2,) or a batch (..., 2): 8 random circles on the mirrored flare
    line, then 40 source rings.

    hw: with a batch of keys (B, 2), per image the valid (h, w) of a
    bucket-padded (h, w) canvas (host ints): the flare line's drawn
    position and the circle radii follow the valid extent."""
    if hw is not None:
        keys = prng.key_data(key).reshape(-1, 2)
        return np.stack([_bloom_params(k, w, vh, vw) for k, (vh, vw)
                         in zip(keys, _hw_rows(hw, keys.shape[0]))])
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
_F32 = np.float32


def to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """img_as_float for u8-domain floats: x * f32(1/255)."""
    return img_u8 * _INV255


def _unit_plus(img_u8: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """to_unit(img) + t with to_unit's multiply contracted into the add."""
    return prng._fma_t(img_u8, _INV255, t)


def _plus_unit(t: torch.Tensor, scale, img_u8: torch.Tensor
               ) -> torch.Tensor:
    """t * scale + to_unit(img) with the generator's multiply contracted
    into the add, as XLA contracts the counter-hash generators."""
    return prng._fma_t(t, scale, to_unit(img_u8))


def _n(x: torch.Tensor) -> int:
    return x[0].numel()


def _f32(x) -> float:
    return float(np.float32(x))


def gaussian(keys, img_u8: torch.Tensor, var,
             fast_bits: bool = False) -> torch.Tensor:
    """x + N(0, var), clipped to [0, 1]; var a float or a (B,) float32
    tensor (the per-image level of the randomized-level quirk)."""
    n, dev = _n(img_u8), img_u8.device
    if fast_bits:
        sd = (torch.sqrt(var.to(torch.float32))[:, None, None, None]
              if isinstance(var, torch.Tensor) else _f32(np.sqrt(_F32(var))))
        z = samplers._normal(keys, n, 64, dev).reshape(img_u8.shape)
        return torch.clamp(_plus_unit(z, sd, img_u8), 0.0, 1.0)
    if isinstance(var, torch.Tensor):
        factor = torch.sqrt(var.to(torch.float32)) * float(prng._SQRT2)
        noise = prng.draw_erf_inv(keys, n, dev) * factor[:, None]
    else:
        noise = prng.draw_normal(keys, n, dev, np.sqrt(np.float32(var)))
    return torch.clamp(_unit_plus(img_u8, noise.reshape(img_u8.shape)),
                       0.0, 1.0)


def salt_and_pepper(keys, img_u8: torch.Tensor, amount: float,
                    salt_vs_pepper: float = 0.5,
                    fast_bits: bool = False) -> torch.Tensor:
    """`amount` of the elements flipped to 1 (salt, p = salt_vs_pepper) or
    0, from two uniform fields of split(key) (or the hash's salts 70 and
    71); the rest to_unit(img)."""
    n, dev = _n(img_u8), img_u8.device
    if fast_bits:
        u = torch.stack([samplers._u01(keys, n, s, dev) for s in (70, 71)],
                        1)
    else:
        u = prng.draw_uniform(prng.split(keys), n, dev)
    flipped = u[:, 0].reshape(img_u8.shape) < _f32(amount)
    salted = u[:, 1].reshape(img_u8.shape) < _f32(salt_vs_pepper)
    out = torch.where(flipped & salted, 1.0, to_unit(img_u8))
    return torch.where(flipped & ~salted, 0.0, out)


def speckle(keys, img_u8: torch.Tensor, var: float,
            fast_bits: bool = False) -> torch.Tensor:
    """x + x * N(0, var), clipped to [0, 1]."""
    n, dev = _n(img_u8), img_u8.device
    sd = np.sqrt(np.float32(var))
    noise = (samplers._normal(keys, n, 66, dev) * float(sd) if fast_bits
             else prng.draw_normal(keys, n, dev, sd)).reshape(img_u8.shape)
    x01 = to_unit(img_u8)
    return torch.clamp(prng._fma_t(x01, noise, x01), 0.0, 1.0)


def uniform_add(keys, img_u8: torch.Tensor, high: float,
                fast_bits: bool = False) -> torch.Tensor:
    """U(0, high) added to to_unit(img), no clip."""
    n, dev = _n(img_u8), img_u8.device
    if fast_bits:
        return _plus_unit(samplers._u01(keys, n, 68, dev).reshape(
            img_u8.shape), _f32(high), img_u8)
    u = prng.draw_uniform(keys, n, dev, 0.0, high)
    return _unit_plus(img_u8, u.reshape(img_u8.shape))


def gamma_add(keys, img_u8: torch.Tensor, scale: float,
              a: float = 1.99, fast_bits: bool = False) -> torch.Tensor:
    """Gamma(a = 1.99, scale) added to to_unit(img), no clip."""
    g = samplers.gamma_fixed(keys, a, _n(img_u8), img_u8.device,
                             fast_bits).reshape(img_u8.shape)
    if fast_bits:
        return _plus_unit(g, _f32(scale), img_u8)
    return _unit_plus(img_u8, g * _f32(scale))


def rayleigh_add(keys, img_u8: torch.Tensor, scale: float,
                 fast_bits: bool = False) -> torch.Tensor:
    """Rayleigh(scale) = scale * sqrt(-2 ln U) added to to_unit(img), no
    clip."""
    n, dev = _n(img_u8), img_u8.device
    u = (samplers._u01(keys, n, 69, dev) if fast_bits
         else prng.draw_uniform(keys, n, dev, np.finfo(np.float32).tiny,
                                1.0))
    r = torch.sqrt(-2.0 * torch.log(u)).reshape(img_u8.shape)
    if fast_bits:
        return _plus_unit(r, _f32(scale), img_u8)
    return _unit_plus(img_u8, r * _f32(scale))


def poisson(keys, img_u8: torch.Tensor,
            fast_bits: bool = False) -> torch.Tensor:
    """skimage's poisson mode: vals = 2^ceil(log2(distinct u8 values)),
    Poisson(x * vals) / vals, clipped to [0, 1]."""
    counts = torch.stack([u8_unique_count(im) for im in img_u8])
    vals = torch.exp2(torch.ceil(torch.log2(counts.to(torch.float64)))).to(
        torch.float32)[:, None, None, None]
    lam = (to_unit(img_u8) * vals).reshape(img_u8.shape[0], -1)
    k = samplers.poisson_fixed(keys, lam, fast_bits).reshape(img_u8.shape)
    return torch.clamp(k / vals, 0.0, 1.0)


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


def _hw_rows(hw, b: int):
    """(B, 2) host ints, one valid (h, w) per image, or None."""
    if hw is None:
        return None
    if isinstance(hw, torch.Tensor) and hw.device.type != 'cpu':
        raise TypeError('hw must be on the host (a device tensor would '
                        'make the noise wait on the device)')
    hw = np.asarray(hw, np.int64).reshape(-1, 2)
    if hw.shape[0] != b:
        raise ValueError('one valid (h, w) per image')
    return [(int(h), int(w)) for h, w in hw]


def brownian(keys, img_u8: torch.Tensor, dt: float, hw=None,
             fast_bits: bool = False) -> torch.Tensor:
    """A Brownian path over each image's element raster: the exclusive
    prefix of sqrt(dt) * N(0, 1), times 255, wrap-cast to u8, then a
    saturating add.  The prefix runs in the fixed log-step order of
    `brownian_path`, which the mix kernel's brownian shares (the
    reference's cumsum sums in XLA's own order).

    hw: per image the valid (h, w) of a bucket-padded canvas (host
    ints); the increments at padded positions are zeroed before the
    prefix, so each valid element's path is the prefix over the valid
    raster."""
    b, h, w, _ = img_u8.shape
    n, dev = _n(img_u8), img_u8.device
    sd = np.sqrt(np.float32(dt))
    db = (samplers._normal(keys, n, 72, dev) * float(sd) if fast_bits
          else prng.draw_normal(keys, n, dev, sd)).reshape(b, h, 3 * w)
    for i, (vh, vw) in enumerate(_hw_rows(hw, b) or ()):
        db[i, vh:] = 0.0
        db[i, :, 3 * vw:] = 0.0
    path = torch.stack([brownian_path(d) for d in db])
    return saturate_u8(img_u8 + wrap_cast_u8(path.reshape(img_u8.shape)
                                             * 255.0))


def periodic(img_u8: torch.Tensor, amplitude: float, hw=None
             ) -> torch.Tensor:
    """sin over linspace(-A, A, n) of the element raster, times 255,
    wrap-cast, saturating add; amplitude < 0 means A = n.  XLA turns the
    step's division by the constant n - 1 into a multiply by its f32
    reciprocal and contracts -A + i * step.

    hw: per image the valid (h, w) of a bucket-padded canvas (host
    ints): the raster index, n and A follow the valid region (the step
    is then a true f32 division: n is data to the reference's
    program)."""
    b, h, w, _ = img_u8.shape
    f32 = np.float32
    dev = img_u8.device
    if hw is None:
        n = _n(img_u8)
        a = f32(n if amplitude < 0 else amplitude)
        step = float((f32(2.0) * a) * (f32(1.0) / f32(n - 1)))
        i = torch.arange(n, dtype=torch.float32, device=dev)
        t = prng._fma_t(i, step, float(-a))
        noise = wrap_cast_u8(torch.sin(t) * 255.0).reshape(img_u8.shape[1:])
        return saturate_u8(img_u8 + noise)
    noise = torch.empty(img_u8.shape, dtype=torch.float32, device=dev)
    x3 = torch.arange(3 * w, device=dev)
    for k, (vh, vw) in enumerate(_hw_rows(hw, b)):
        n = vh * vw * 3
        a = f32(n if amplitude < 0 else amplitude)
        step = float((f32(2.0) * a) / (f32(n) - f32(1.0)))
        idx = torch.arange(h, device=dev)[:, None] * (3 * vw) + x3
        t = prng._fma_t(idx.to(torch.float32), step, float(-a))
        noise[k] = wrap_cast_u8(torch.sin(t) * 255.0).reshape(h, w, 3)
    return saturate_u8(img_u8 + noise)


def shader(img_u8: torch.Tensor, factor: float = 3.0) -> torch.Tensor:
    """PIL ImageEnhance.Brightness(3) on the BGR image read as RGB: the
    result comes back channel-swapped."""
    return saturate_u8(img_u8 * factor).flip(-1)
