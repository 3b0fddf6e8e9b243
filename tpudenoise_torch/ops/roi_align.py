"""RoI crop-and-resize (counterpart of `tpudenoise/ops/roi_align.py`):
tf.image.crop_and_resize bilinear semantics as two matmuls per RoI,
out[r] = A_r @ feat @ B_r^T, with A/B the (S, H)/(S, W) tap weights built
in the feature dtype, as the reference builds them."""

from __future__ import annotations

import torch


def _interp_weights(coords: torch.Tensor, size: int, dtype) -> torch.Tensor:
    """(..., S) sample positions -> (..., S, size) bilinear taps; samples
    outside [0, size-1] get all-zero rows (extrapolation value 0)."""
    valid = (coords >= 0) & (coords <= size - 1)
    c0 = torch.floor(coords)
    frac = coords - c0
    c0i = torch.clamp(c0, 0, size - 1).to(torch.int64)
    c1i = torch.clamp(c0i + 1, 0, size - 1)
    iota = torch.arange(size, device=coords.device)
    w = ((iota == c0i[..., None]) * (1.0 - frac[..., None])
         + (iota == c1i[..., None]) * frac[..., None])
    return torch.where(valid[..., None], w, 0.0).to(dtype)


def _sample_grid(boxes: torch.Tensor, h: int, w: int, crop_size: int):
    y1, x1, y2, x2 = boxes.unbind(-1)
    if crop_size > 1:
        hs = (y2 - y1) * (h - 1) / (crop_size - 1)
        ws = (x2 - x1) * (w - 1) / (crop_size - 1)
        grid = torch.arange(crop_size, dtype=boxes.dtype, device=boxes.device)
        in_y = y1[..., None] * (h - 1) + grid * hs[..., None]
        in_x = x1[..., None] * (w - 1) + grid * ws[..., None]
    else:
        in_y = (0.5 * (y1 + y2) * (h - 1))[..., None]
        in_x = (0.5 * (x1 + x2) * (w - 1))[..., None]
    return in_y, in_x


def crop_and_resize(feat: torch.Tensor, boxes: torch.Tensor,
                    crop_size: int) -> torch.Tensor:
    """feat (B, H, W, C); boxes (B, R, 4) normalized (y1, x1, y2, x2).
    Returns (B, R, S, S, C) in the feature dtype."""
    b, h, w, c = feat.shape
    r, s = boxes.shape[1], crop_size
    in_y, in_x = _sample_grid(boxes.to(torch.float32), h, w, crop_size)
    a = _interp_weights(in_y, h, feat.dtype)             # (B, R, S, H)
    bw = _interp_weights(in_x, w, feat.dtype)            # (B, R, S, W)
    # y contraction: (B, R*S, H) @ (B, H, W*C)
    t = torch.matmul(a.reshape(b, r * s, h), feat.reshape(b, h, w * c))
    # x contraction per RoI: (B*R, S, W) @ (B*R, W, S*C)
    t = t.reshape(b * r, s, w, c).permute(0, 2, 1, 3).reshape(b * r, w, s * c)
    out = torch.matmul(bw.reshape(b * r, s, w), t)       # (B*R, Sj, Si*C)
    return out.reshape(b, r, s, s, c).permute(0, 1, 3, 2, 4).contiguous()


def max_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """slim.max_pool2d([2, 2], padding='SAME') over (..., H, W, C): SAME
    pads the far edge with -inf, as ceil_mode does.  Through max_pool2d,
    whose gradient goes to the first maximum of each window, as XLA's
    reduce_window (select_and_scatter) routes it; a mean over ties would
    split it."""
    *lead, h, w, c = x.shape
    y = torch.nn.functional.max_pool2d(
        x.reshape(-1, h, w, c).permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[2], y.shape[3], c)


def roi_boxes_to_normalized(rois: torch.Tensor, feat_hw, feat_stride: float
                            ) -> torch.Tensor:
    """Image-space (..., 4) (x1, y1, x2, y2) rois -> normalized
    (y1, x1, y2, x2) over (feat_dim - 1) * stride."""
    fh, fw = feat_hw
    height = (fh - 1.0) * feat_stride
    width = (fw - 1.0) * feat_stride
    x1, y1, x2, y2 = rois.unbind(-1)
    return torch.stack([y1 / height, x1 / width, y2 / height, x2 / width],
                       dim=-1)
