"""Anchor generation (counterpart of `tpudenoise/ops/anchors.py`): the
reference's base-anchor table, shifted over the feature grid with the
`_tf` path's int32 truncation, in H x W x A raster order."""

from __future__ import annotations

import numpy as np
import torch


def generate_anchors(base_size: int = 16, ratios=(0.5, 1, 2),
                     scales=(8, 16, 32)) -> np.ndarray:
    """The 9 base anchors around the (0, 0, 15, 15) window, float64."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w, h, cx, cy = _whctrs(base)
    ws = np.round(np.sqrt(w * h / ratios))
    ratio_anchors = _mkanchors(ws, np.round(ws * ratios), cx, cy)
    out = []
    for a in ratio_anchors:
        w, h, cx, cy = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, cx, cy))
    return np.vstack(out)


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def anchor_grid(height: int, width: int, feat_stride: int = 16,
                anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                device=None) -> torch.Tensor:
    """(H*W*A, 4) float32 anchors; anchors vary fastest, then x, then y."""
    base = generate_anchors(ratios=anchor_ratios, scales=anchor_scales)
    base = torch.as_tensor(base.astype(np.int32), device=device)
    sx = torch.arange(width, dtype=torch.int32, device=device) * feat_stride
    sy = torch.arange(height, dtype=torch.int32, device=device) * feat_stride
    yy, xx = torch.meshgrid(sy, sx, indexing='ij')
    shifts = torch.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()], 1)
    return (base[None] + shifts[:, None]).reshape(-1, 4).to(torch.float32)


def num_anchors(anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2)) -> int:
    return len(anchor_scales) * len(anchor_ratios)
