"""The Automold road-scene augmentations (counterpart of
`tpudenoise/noise/automold.py`) over float32 (H, W, 3) tensors holding
u8 values, on the device they come on.

Randomness is a JAX key ((2,) uint32, `core.prng`): each function splits
and draws with the port's key ops, so one key draws the numbers
`jax.random` draws (5 randint, 7 split and 14 uniform calls in all).
The draws are small (scalars and per-drop coordinates) and are made on
the host; the pixels stay on the device.

Shapes are rendered as full-image masks, as in the JAX package.  Where
the JAX package composites in a `lax.scan`, the port loops in the same
order, or (rain streaks, which all paint one colour, and gravel specks,
where the last speck that covers a pixel wins) tests every element
against every pixel in one vectorized pass and keeps what the scan would
have kept.  `augment_random`'s `lax.switch` is a dispatch on the drawn
index.  `add_sun_flare` is the 'bloom' generator: kernel 8
(`csrc/bloom.cu`, through `noise.bloom.bloom_batched`) on a CUDA tensor,
`generators.bloom_apply_scan` on a CPU one.

Like the reference, the functions take the array as given: the colour
helpers select RGB or BGR by `src`, the augmentations assume RGB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.noise.generators import saturate_u8
from tpudenoise_torch.ops.color import (hls_u8_to_rgb_u8, hsv_u8_to_rgb_u8,
                                        rgb_u8_to_hls_u8, rgb_u8_to_hsv_u8)

_F32 = np.float32
# how many rain drops or gravel specks one vectorized pass tests
_CHUNK = 64


# ------------------------------------------------- colour-space helpers --

def _map_images(image, fn):
    if isinstance(image, (list, tuple)):
        return [fn(img) for img in image]
    return fn(image)


def _as_rgb(img, src):
    src = src.upper()
    if src not in ('RGB', 'BGR'):
        raise ValueError(f'unsupported source space {src}')
    return img.flip(-1) if src == 'BGR' else img


def hls(image, src='RGB'):
    """cv2 {src}2HLS of an image or a list of images."""
    return _map_images(image, lambda im: rgb_u8_to_hls_u8(_as_rgb(im, src)))


def hue(image, src='RGB'):
    """The H plane of HLS."""
    return _map_images(image, lambda im: rgb_u8_to_hls_u8(
        _as_rgb(im, src))[..., 0])


def lightness(image, src='RGB'):
    """The L plane of HLS."""
    return _map_images(image, lambda im: rgb_u8_to_hls_u8(
        _as_rgb(im, src))[..., 1])


def saturation(image, src='RGB'):
    """The S plane of HLS."""
    return _map_images(image, lambda im: rgb_u8_to_hls_u8(
        _as_rgb(im, src))[..., 2])


def hsv(image, src='RGB'):
    """cv2 {src}2HSV."""
    return _map_images(image, lambda im: rgb_u8_to_hsv_u8(_as_rgb(im, src)))


def value(image, src='RGB'):
    """The V plane of HSV."""
    return _map_images(image, lambda im: rgb_u8_to_hsv_u8(
        _as_rgb(im, src))[..., 2])


def bgr(image, src='RGB'):
    """To BGR from RGB, BGR, 'HLS' or 'HSV'."""
    s = src.upper()
    if s == 'HLS':
        return _map_images(image, lambda im: hls_u8_to_rgb_u8(im).flip(-1))
    if s == 'HSV':
        return _map_images(image, lambda im: hsv_u8_to_rgb_u8(im).flip(-1))
    return _map_images(image, lambda im: _as_rgb(im, s).flip(-1))


def rgb(image, src='BGR'):
    """To RGB from BGR, RGB, 'HLS' or 'HSV'."""
    s = src.upper()
    if s == 'HLS':
        return _map_images(image, hls_u8_to_rgb_u8)
    if s == 'HSV':
        return _map_images(image, hsv_u8_to_rgb_u8)
    return _map_images(image, lambda im: _as_rgb(im, s))


def red(image, src='BGR'):
    """The R plane."""
    return _map_images(image, lambda im: _as_rgb(im, src)[..., 0])


def green(image, src='BGR'):
    """The G plane."""
    return _map_images(image, lambda im: _as_rgb(im, src)[..., 1])


def blue(image, src='BGR'):
    """The B plane."""
    return _map_images(image, lambda im: _as_rgb(im, src)[..., 2])


# ----------------------------------------------------------- helpers --

def _grid(img: torch.Tensor):
    """(yy, xx) float32 pixel coordinates of img's (H, W), on its device."""
    h, w = img.shape[0], img.shape[1]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def _with_light(hls_img: torch.Tensor, light: torch.Tensor) -> torch.Tensor:
    """RGB of hls_img with its L plane replaced."""
    return hls_u8_to_rgb_u8(torch.stack(
        [hls_img[..., 0], light, hls_img[..., 2]], -1))


def _vec(a, img: torch.Tensor) -> torch.Tensor:
    """A host array as a float32 tensor on img's device."""
    return torch.from_numpy(np.asarray(a, _F32)).to(img.device)


# --------------------------------------------------------- lightness ----

def change_light(img_u8: torch.Tensor, coeff) -> torch.Tensor:
    """Scale the HLS lightness by the float32 coeff."""
    hls_img = rgb_u8_to_hls_u8(img_u8)
    light = torch.clamp(hls_img[..., 1] * float(_F32(coeff)), 0.0, 255.0)
    return _with_light(hls_img, torch.round(light))


def brighten(key, img_u8, brightness_coeff: float = -1.0):
    """coeff -1: 1 + U(0, 1); else 1 + coeff."""
    c = (_F32(1.0) + prng.uniform(key, ()) if brightness_coeff < 0
         else _F32(1.0 + brightness_coeff))
    return change_light(img_u8, c)


def darken(key, img_u8, darkness_coeff: float = -1.0):
    c = (_F32(1.0) - prng.uniform(key, ()) if darkness_coeff < 0
         else _F32(1.0 - darkness_coeff))
    return change_light(img_u8, c)


def random_brightness(key, img_u8):
    return change_light(img_u8, _F32(2.0) * prng.uniform(key, ()))


# ------------------------------------------------------------ shadow ----

def add_shadow(key, img_u8, no_of_shadows: int = 1,
               shadow_dimension: int = 5):
    """Random convex polygons (shadow_dimension vertices in the lower
    half) halve the lightness inside, one after another.  A polygon is
    the AND of its edges' half-planes, its vertices sorted by angle about
    their mean."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    yy, xx = _grid(img_u8)
    hls_img = rgb_u8_to_hls_u8(img_u8)
    light = hls_img[..., 1]
    for k in prng.split(key, no_of_shadows):
        kx, ky, _ = prng.split(k, 3)
        vx = prng.uniform(kx, (shadow_dimension,), 0, w)
        vy = prng.uniform(ky, (shadow_dimension,), h / 2, h)
        cx = vx.sum(dtype=_F32) / _F32(shadow_dimension)
        cy = vy.sum(dtype=_F32) / _F32(shadow_dimension)
        order = np.argsort(np.arctan2(vy - cy, vx - cx), kind='stable')
        vx, vy = vx[order], vy[order]
        ex, ey = np.roll(vx, -1) - vx, np.roll(vy, -1) - vy
        mask = torch.ones_like(light, dtype=torch.bool)
        for e_x, e_y, v_x, v_y in zip(ex.tolist(), ey.tolist(), vx.tolist(),
                                      vy.tolist()):
            mask &= (e_x * (yy - v_y) - e_y * (xx - v_x)) >= 0
        light = torch.where(mask, torch.round(light * 0.5), light)
    return _with_light(hls_img, light)


# -------------------------------------------------------------- snow ----

def add_snow(key, img_u8, snow_coeff: float = -1.0):
    """Lightness below the snow point (coeff * 255/2 + 255/3) times 2.5,
    at most 255, truncated."""
    c = prng.uniform(key, ()) if snow_coeff < 0 else _F32(snow_coeff)
    snow_point = float(_F32(c) * _F32(255.0 / 2.0) + _F32(255.0 / 3.0))
    hls_img = rgb_u8_to_hls_u8(img_u8)
    light = hls_img[..., 1]
    light = torch.where(light < snow_point,
                        torch.clamp(light * 2.5, max=255.0), light)
    return _with_light(hls_img, torch.trunc(light))


# -------------------------------------------------------------- rain ----

def add_rain(key, img_u8, slant: int = -1, drop_length: int = 20,
             drop_width: int = 1, drop_color=(200, 200, 200),
             rain_type: str = 'None'):
    """Slanted streaks (area // 600 drops; drizzle area // 770 of length
    10, heavy length 30, torrential area // 500 of length 60) painted in
    drop_color where a pixel lies within 0.7 * drop_width of a drop's
    segment, then a 7x7 box blur (reflected edges) and lightness x 0.7."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    area = h * w
    rt = rain_type.lower()
    if rt == 'drizzle':
        n_drops, drop_length = area // 770, 10
    elif rt == 'heavy':
        n_drops, drop_length = area // 600, 30
    elif rt == 'torrential':
        n_drops, drop_length = area // 500, 60
    else:
        n_drops = area // 600
    k_slant, k_xy = prng.split(key)
    slant_v = _F32(prng.randint(k_slant, (), -10, 10) if slant == -1
                   else slant)
    kx, ky = prng.split(k_xy)
    x0 = prng.uniform(kx, (n_drops,), 0, _F32(w) - abs(slant_v))
    y0 = prng.uniform(ky, (n_drops,), 0, h - drop_length)
    # each segment's direction as the JAX package rounds it: (x0 + slant)
    # - x0 and (y0 + length) - y0 in float32
    ex = (x0 + slant_v) - x0
    ey = (y0 + _F32(drop_length)) - y0
    seg = _vec(np.stack([x0, y0, ex, ey, ex * ex + ey * ey]), img_u8)
    yy, xx = _grid(img_u8)
    half_w = max(drop_width, 1) * 0.7
    # every drop paints the same colour: a pixel ends in it if any drop's
    # streak covers it, in whatever order they are drawn
    hit = torch.zeros((h, w), dtype=torch.bool, device=img_u8.device)
    for i in range(0, n_drops, _CHUNK):
        dx0, dy0, e_x, e_y, len2 = seg[:, i:i + _CHUNK, None, None]
        t = torch.clamp(((xx - dx0) * e_x + (yy - dy0) * e_y) / len2,
                        0.0, 1.0)
        d2 = (xx - (dx0 + t * e_x)) ** 2 + (yy - (dy0 + t * e_y)) ** 2
        hit |= (d2 <= half_w * half_w).any(0)
    color = torch.tensor(drop_color, dtype=torch.float32,
                         device=img_u8.device)
    img = torch.where(hit[..., None], color, img_u8.to(torch.float32))
    img = torch.round(_box_sum(img, 7) / 49.0)
    hls_img = rgb_u8_to_hls_u8(img)
    return _with_light(hls_img, torch.trunc(hls_img[..., 1] * 0.7))


def _box_sum(img: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k sum of (H, W, 3) values with reflected edges (numpy's
    'reflect'), rows of the window summed first, then the rows."""
    r = k // 2
    p = torch.nn.functional.pad(img.permute(2, 0, 1)[None], (r, r, r, r),
                                mode='reflect')[0].permute(1, 2, 0)
    h, w = img.shape[0], img.shape[1]
    acc = torch.zeros_like(img)
    for dy in range(k):
        row = p[dy:dy + h]
        racc = torch.zeros_like(img)
        for dx in range(k):
            racc = racc + row[:, dx:dx + w]
        acc = acc + racc
    return acc


# --------------------------------------------------------------- fog ----

def add_fog(key, img_u8, fog_coeff: float = -1.0, max_circles: int = 96):
    """max_circles haze circles (radius w/3 * coeff / 2, alpha 0.08 *
    coeff) blended toward white one after another, then a 9x9 box blur
    with reflected edges."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    kc, kx, ky = prng.split(key, 3)
    c = (prng.uniform(kc, (), 0.3, 1.0) if fog_coeff < 0
         else _F32(fog_coeff))
    rad = float(_F32(w / 3.0) * c / _F32(2.0))
    alpha = float(_F32(0.08) * c)
    beta = float(_F32(1.0) - _F32(alpha))
    cxs = prng.uniform(kx, (max_circles,), 0, w)
    cys = prng.uniform(ky, (max_circles,), 0, h)
    yy, xx = _grid(img_u8)
    img = img_u8.to(torch.float32)
    for cx, cy in zip(cxs.tolist(), cys.tolist()):
        mask = ((xx - cx - rad) ** 2 + (yy - cy - rad) ** 2) <= rad * rad
        overlay = torch.where(mask[..., None], 255.0, img)
        img = saturate_u8(alpha * overlay + beta * img)
    return torch.round(_box_sum(img, 9) / 81.0)


# ------------------------------------------------------------ gravel ----

def add_gravel(key, img_u8, no_of_patches: int = 8, per_patch: int = 60):
    """no_of_patches * per_patch square specks (half-size 1-4) in the
    bottom quarter set the HLS lightness to a random level; a later speck
    overwrites an earlier one."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    y1 = int(h * 3 / 4)
    hls_img = rgb_u8_to_hls_u8(img_u8)
    yy, xx = _grid(img_u8)
    n = no_of_patches * per_patch
    kx, ky, kr, kl = prng.split(key, 4)
    gx = _vec(prng.uniform(kx, (n,), 0, w), img_u8)
    gy = _vec(prng.uniform(ky, (n,), y1, h), img_u8)
    gr = _vec(prng.randint(kr, (n,), 1, 5), img_u8)
    gl = _vec(prng.randint(kl, (n,), 0, 256), img_u8)
    # the last speck over each pixel, -1 for none
    last = torch.full((h, w), -1, dtype=torch.int64, device=img_u8.device)
    for i in range(0, n, _CHUNK):
        sl = slice(i, i + _CHUNK)
        cover = ((torch.abs(xx - gx[sl, None, None]) <= gr[sl, None, None])
                 & (torch.abs(yy - gy[sl, None, None])
                    <= gr[sl, None, None]))
        idx = torch.arange(i, i + cover.shape[0], device=img_u8.device)
        last = torch.maximum(last, torch.where(
            cover, idx[:, None, None], -1).amax(0))
    light = torch.where(last >= 0, gl[last.clamp(min=0)], hls_img[..., 1])
    return _with_light(hls_img, light)


# -------------------------------------------------- sun flare / bloom ---

def add_sun_flare(key, img_u8, flare_center=(100, 100),
                  angle: float = -math.pi / 4):
    """The 'bloom' generator (flare centre (100, 100), angle -pi/4, the
    reference's defaults): `generators.bloom_params` on the host, then
    kernel 8 on a CUDA tensor or its plain version on a CPU one."""
    from tpudenoise_torch.noise.bloom import bloom_batched
    from tpudenoise_torch.noise.generators import bloom_params
    h, w = img_u8.shape[0], img_u8.shape[1]
    params = torch.from_numpy(bloom_params(key, h, w)).to(img_u8.device)
    return bloom_batched(img_u8[None], params[None])[0]


# -------------------------------------------------------- motion blur ---

def apply_motion_blur(img_u8, count: int):
    """A horizontal 15-tap mean (reflected edges), rounded, over strips
    that widen from both sides, as many as the count leaves."""
    w = img_u8.shape[1]
    size = 15
    r = size // 2
    p = torch.nn.functional.pad(img_u8.to(torch.float32).permute(2, 0, 1),
                                (r, r), mode='reflect').permute(1, 2, 0)
    acc = p[:, 0:w]
    for i in range(1, size):
        acc = acc + p[:, i:i + w]
    blurred = torch.round(acc / float(size))
    xx = torch.arange(w, device=img_u8.device)[None, :, None]
    i = w * 3 // 4 - 10 * count
    out = img_u8
    cnt = count
    while i <= w:
        out = torch.where((xx >= i) | (xx < w - i), blurred, out)
        i += max(w // 25 - cnt, 1)
        cnt += 1
    return out


def add_speed(key, img_u8, speed_coeff: float = -1.0):
    """coeff -1: count 7 (the JAX package's fixed mid-range count); else
    int(15 * coeff)."""
    count = 7 if speed_coeff < 0 else int(15 * speed_coeff)
    return apply_motion_blur(img_u8, count)


# ------------------------------------------------------------ autumn ----

def add_autumn(key, img_u8, step: int = 8):
    """step x step tiles whose mean hue lies in (20, 100) and mean G below
    100 get one drawn hue of (1, 5, 9, 11) and saturation 255."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    hls_img = rgb_u8_to_hls_u8(img_u8)
    col = (1.0, 5.0, 9.0, 11.0)[int(prng.randint(key, (), 0, 4))]
    hh, ww = (h // step) * step, (w // step) * step

    def tiles(plane):
        return plane[:hh, :ww].reshape(hh // step, step, ww // step,
                                       step).mean(dim=(1, 3))

    hue_avg, g_avg = tiles(hls_img[..., 0]), tiles(img_u8[..., 1])
    sel = (hue_avg > 20) & (hue_avg < 100) & (g_avg < 100)
    sel = sel.repeat_interleave(step, 0).repeat_interleave(step, 1)
    sel = torch.nn.functional.pad(sel, (0, w - ww, 0, h - hh))
    return hls_u8_to_rgb_u8(torch.stack(
        [torch.where(sel, col, hls_img[..., 0]), hls_img[..., 1],
         torch.where(sel, 255.0, hls_img[..., 2])], -1))


# ----------------------------------------------------- flips/manhole ----

def fliph(img_u8):
    """cv2.flip(img, 0): upside down."""
    return img_u8.flip(0)


def flipv(img_u8):
    """cv2.flip(img, 1): left-right."""
    return img_u8.flip(1)


def random_flip(key, img_u8):
    """Upside down when U(0, 1) > 0.5, else left-right."""
    return fliph(img_u8) if prng.uniform(key, ()) > 0.5 else flipv(img_u8)


def add_manhole(key, img_u8, center=None, color=(67, 70, 75),
                height: int = 0, width: int = 0):
    """A filled ellipse (half-axes width, height; default h * 3 // 25 and
    h // 25) at center (y, x), default (h - 100, w // 2)."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    height = height or h // 25
    width = width or h * 3 // 25
    cy, cx = center if center is not None else (h - 100, w // 2)
    yy, xx = _grid(img_u8)
    mask = (((xx - cx) / width) ** 2 + ((yy - cy) / height) ** 2) <= 1.0
    color = torch.tensor(color, dtype=torch.float32, device=img_u8.device)
    return torch.where(mask[..., None], color, img_u8.to(torch.float32))


# ---------------------------------------------------------- exposure ----

def correct_exposure(img_u8):
    """Histogram equalization of the luma (BGR weights), applied to every
    channel as the gain new / old luma."""
    # XLA contracts the weighted sum into fma(0.299, R, fma(0.114, B,
    # 0.587 * G)); a rounding apart, a luma on .5 would round the other way
    b, g, r = img_u8[..., 0], img_u8[..., 1], img_u8[..., 2]
    luma = torch.round(prng._fma_t(
        r, float(_F32(0.299)), prng._fma_t(b, float(_F32(0.114)),
                                           g * 0.587)))
    flat = luma.reshape(-1).to(torch.int64)
    hist = torch.zeros(256, dtype=torch.float32, device=img_u8.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    cdf = torch.cumsum(hist, 0)
    cdf_min = cdf[torch.argmax((hist > 0).to(torch.int32))]
    n = flat.shape[0]
    lut = torch.round((cdf - cdf_min) / torch.clamp(n - cdf_min, min=1.0)
                      * 255.0)
    gain = lut[flat].reshape(luma.shape) / torch.clamp(luma, min=1.0)
    return saturate_u8(img_u8 * gain[..., None])


AUG_TYPES = ["random_brightness", "add_shadow", "add_snow", "add_rain",
             "add_fog", "add_gravel", "add_sun_flare", "add_speed",
             "add_autumn", "random_flip", "add_manhole"]

_AUGMENT = {
    'random_brightness': random_brightness,
    'add_shadow': add_shadow,
    'add_snow': add_snow,
    'add_rain': add_rain,
    'add_fog': add_fog,
    'add_gravel': add_gravel,
    'add_sun_flare': add_sun_flare,
    'add_speed': lambda k, im: add_speed(k, im, 0.5),
    'add_autumn': add_autumn,
    'random_flip': random_flip,
    'add_manhole': add_manhole,
}


def augment_random(key, img_u8, aug_types=None):
    """One augmentation of aug_types (default AUG_TYPES), picked by a
    randint of the key's first half and applied with its second; returns
    float32."""
    names = aug_types or AUG_TYPES
    k_pick, k_fn = prng.split(key)
    idx = int(prng.randint(k_pick, (), 0, len(names)))
    return _AUGMENT[names[idx]](k_fn, img_u8).to(torch.float32)
