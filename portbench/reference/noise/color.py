# Frozen copy of tpudenoise_torch/ops/color.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""BGR <-> LAB for 8-bit images (counterpart of `tpudenoise/ops/color.py`
`bgr_u8_to_lab_u8` / `lab_u8_to_bgr_u8`, the cv2.cvtColor math).

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
