"""BGR <-> LAB for 8-bit images (counterpart of `tpudenoise/ops/color.py`
`bgr_u8_to_lab_u8` / `lab_u8_to_bgr_u8`, the cv2.cvtColor math), and the
BT.601 YCbCr pair of the wavelet denoiser (`rgb01_to_ycbcr`,
`ycbcr_to_rgb01`, skimage's convention).

The k-means palette of the "quant" noise is fitted on these LAB values
(`noise/mix_prologue.py`).  The mix kernel maps pixels with its own,
inlined LAB form (exp/log for the powers, `mix_kernels.py`), as the
reference does; the two forms are kept apart on purpose.

Images are float32 tensors holding u8 values, channel-last, BGR.  The
forms follow the reference: `** 2.4`, cube root, the (3, 3) matrix
product.  torch has no cube root, so it is taken in float64 and rounded,
which is what a correctly rounded f32 `cbrt` gives.
"""

from __future__ import annotations

import numpy as np
import torch

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]], np.float32)
_XN, _ZN = float(np.float32(0.950456)), float(np.float32(1.088754))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    t64 = t.to(torch.float64)
    return (torch.sign(t64) * t64.abs() ** (1.0 / 3.0)).to(torch.float32)


def _srgb_to_linear(v):
    return torch.where(v > _f32(0.04045),
                       ((v + _f32(0.055)) / _f32(1.055)) ** _f32(2.4),
                       v / _f32(12.92))


def _linear_to_srgb(v):
    return torch.where(
        v > _f32(0.0031308),
        _f32(1.055) * torch.clamp(v, min=_f32(1e-12)) ** _f32(1 / 2.4)
        - _f32(0.055),
        _f32(12.92) * v)


def _f_lab(t):
    return torch.where(t > _f32(0.008856), _cbrt(t),
                       _f32(7.787) * t + _f32(16.0 / 116.0))


def bgr_u8_to_lab_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_BGR2LAB) for 8-bit input; in/out float32
    holding u8 values, (..., 3)."""
    rgb = (img * _f32(1.0 / 255.0)).flip(-1)
    lin = _srgb_to_linear(rgb)
    xyz = lin @ torch.from_numpy(_RGB2XYZ.T.copy()).to(img.device)
    x = xyz[..., 0] / _XN
    y = xyz[..., 1]
    z = xyz[..., 2] / _ZN
    L = torch.where(y > _f32(0.008856), _f32(116.0) * _cbrt(y) - 16.0,
                    _f32(903.3) * y)
    a = _f32(500.0) * (_f_lab(x) - _f_lab(y)) + 128.0
    b = _f32(200.0) * (_f_lab(y) - _f_lab(z)) + 128.0
    out = torch.stack([L * _f32(255.0 / 100.0), a, b], -1)
    return torch.clamp(torch.round(out), 0.0, 255.0)


def lab_u8_to_bgr_u8(lab: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_LAB2BGR) for 8-bit input."""
    L = lab[..., 0] * _f32(100.0 / 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(f):
        t3 = f * (f * f)
        return torch.where(t3 > _f32(0.008856), t3,
                           (f - _f32(16.0 / 116.0)) / _f32(7.787))

    y = torch.where(L > _f32(903.3 * 0.008856), fy * (fy * fy),
                    L / _f32(903.3))
    xyz = torch.stack([finv(fx) * _XN, y, finv(fz) * _ZN], -1)
    lin = xyz @ torch.from_numpy(_XYZ2RGB.T.copy()).to(lab.device)
    rgb = _linear_to_srgb(torch.clamp(lin, 0.0, 1.0))
    return torch.clamp(torch.round(rgb.flip(-1) * 255.0), 0.0, 255.0)


def rgb01_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """skimage rgb2ycbcr on (..., 3) floats in [0, 1]: Y in [16, 235],
    Cb/Cr in [16, 240].  The wavelet feeds it BGR with no swap, as the
    reference does."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + _f32(65.481) * r + _f32(128.553) * g + _f32(24.966) * b
    cb = 128.0 - _f32(37.797) * r - _f32(74.203) * g + 112.0 * b
    cr = 128.0 + 112.0 * r - _f32(93.786) * g - _f32(18.214) * b
    return torch.stack([y, cb, cr], -1)


def ycbcr_to_rgb01(ycbcr: torch.Tensor) -> torch.Tensor:
    """The inverse transform, to [0, 1]-scaled floats (not clipped)."""
    y = ycbcr[..., 0] - 16.0
    cb = ycbcr[..., 1] - 128.0
    cr = ycbcr[..., 2] - 128.0
    r = _f32(0.00456621) * y + _f32(0.00625893) * cr
    g = _f32(0.00456621) * y - _f32(0.00153632) * cb - _f32(0.00318811) * cr
    b = _f32(0.00456621) * y + _f32(0.00791071) * cb
    return torch.stack([r, g, b], -1)


# ------------------------------------------------------- HLS and HSV --
# cv2's 8-bit HLS and HSV (H in [0, 180), the rest in [0, 255]), the
# Automold suite's colour spaces; in and out float32 holding u8 values,
# RGB order, (..., 3).

_INV255 = _f32(1.0 / 255.0)
# H / 60 as XLA rewrites a division by a constant: H * f32(1 / 60)
_INV60 = _f32(1.0 / 60.0)


def _hue(r, g, b, vmax, c):
    """Hue in degrees [0, 360) from RGB in [0, 1]: 0 where c == 0."""
    safe_c = torch.clamp(c, min=_f32(1e-12))
    h = torch.where(vmax == r, (g - b) / safe_c,
                    torch.where(vmax == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c == 0, 0.0, h) * 60.0
    return torch.where(h < 0, h + 360.0, h)


def rgb_u8_to_hls_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_RGB2HLS) for 8-bit input."""
    x = img * _INV255
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    l = (vmax + vmin) * 0.5
    c = vmax - vmin
    s = torch.where(c == 0, 0.0, torch.where(
        l < 0.5, c / torch.clamp(vmax + vmin, min=_f32(1e-12)),
        c / torch.clamp(2.0 - vmax - vmin, min=_f32(1e-12))))
    out = torch.stack([_hue(r, g, b, vmax, c) * 0.5, l * 255.0, s * 255.0],
                      -1)
    return torch.clamp(torch.round(out), 0.0, 255.0)


def rgb_u8_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_RGB2HSV) for 8-bit input."""
    x = img * _INV255
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    c = vmax - vmin
    s = torch.where(vmax == 0, 0.0, c / torch.clamp(vmax, min=_f32(1e-12)))
    out = torch.stack([_hue(r, g, b, vmax, c) * 0.5, s * 255.0,
                       vmax * 255.0], -1)
    return torch.clamp(torch.round(out), 0.0, 255.0)


def _sector_rgb(hp, c, m):
    """RGB from the hue sector hp = H / 60, chroma c and offset m, as
    u8-domain floats."""
    xcomp = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.clamp(torch.floor(hp), 0, 5)
    # sector: 0 (c, x, 0), 1 (x, c, 0), 2 (0, c, x), 3 (0, x, c),
    # 4 (x, 0, c), 5 (c, 0, x)
    r = torch.where((idx == 0) | (idx == 5), c,
                    torch.where((idx == 1) | (idx == 4), xcomp, z))
    g = torch.where((idx == 1) | (idx == 2), c,
                    torch.where((idx == 0) | (idx == 3), xcomp, z))
    b = torch.where((idx == 3) | (idx == 4), c,
                    torch.where((idx == 2) | (idx == 5), xcomp, z))
    out = torch.stack([r + m, g + m, b + m], -1) * 255.0
    return torch.clamp(torch.round(out), 0.0, 255.0)


def hsv_u8_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_HSV2RGB) for 8-bit input."""
    h = hsv[..., 0] * 2.0
    s = hsv[..., 1] * _INV255
    v = hsv[..., 2] * _INV255
    c = v * s
    return _sector_rgb(h * _INV60, c, v - c)


def hls_u8_to_rgb_u8(hls: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_HLS2RGB) for 8-bit input."""
    h = hls[..., 0] * 2.0
    l = hls[..., 1] * _INV255
    s = hls[..., 2] * _INV255
    c = torch.where(l < 0.5, 2.0 * l * s, (2.0 - 2.0 * l) * s)
    return _sector_rgb(h * _INV60, c, l - 0.5 * c)
