"""Bilinear resize as separable banded matmuls (counterpart of
`tpudenoise/ops/resize.py`), reproducing cv2.INTER_LINEAR's coordinate
convention: src = (dst + 0.5) / scale - 0.5, clamped, two taps.  Rows and
columns beyond the output extent get zero weights, so the result arrives
zero-padded to the bucket.  Coordinates in f32; the products are f32
`torch.matmul` (TF32 must be off on the card: the caller's entry point
sets it)."""

from __future__ import annotations

import torch


def resize_weights(out_size: int, in_size: int, out_len, in_len, scale,
                   device=None) -> torch.Tensor:
    """(..., out_size, in_size) f32 bilinear row weights.  out_len,
    in_len and scale are scalars or tensors of a common leading shape."""
    f32 = dict(dtype=torch.float32, device=device)
    out_len = torch.as_tensor(out_len, **f32)[..., None]
    in_len = torch.as_tensor(in_len, **f32)[..., None]
    ratio = 1.0 / torch.as_tensor(scale, **f32)[..., None]
    y = torch.arange(out_size, **f32)
    s = torch.minimum(torch.clamp((y + 0.5) * ratio - 0.5, min=0.0),
                      in_len - 1.0)
    i0 = torch.minimum(torch.clamp(torch.floor(s), min=0.0),
                       torch.clamp(in_len - 2.0, min=0.0))
    f = s - i0
    i = torch.arange(in_size, **f32)
    w = ((i == i0[..., None]) * (1.0 - f)[..., None]
         + (i == i0[..., None] + 1.0) * f[..., None])
    return torch.where((y < out_len)[..., None], w, 0.0)


def resize_to_bucket(img: torch.Tensor, h0, w0, oh, ow, scale,
                     out_bucket: tuple) -> torch.Tensor:
    """Resize the valid (h0, w0) region of (B, BH, BW, C) canvases by
    `scale` to (oh, ow), zero-padded into (B, PH, PW, C).  Geometry args
    are (B,) tensors or scalars."""
    b, bh, bw, c = img.shape
    ph, pw = out_bucket
    wh = resize_weights(ph, bh, oh, h0, scale, img.device).expand(b, ph, bh)
    ww = resize_weights(pw, bw, ow, w0, scale, img.device).expand(b, pw, bw)
    t = torch.matmul(wh, img.reshape(b, bh, bw * c))            # (B,PH,BW*C)
    t = t.reshape(b, ph, bw, c).permute(0, 2, 1, 3).reshape(b, bw, ph * c)
    out = torch.matmul(ww, t)                                   # (B,PW,PH*C)
    return out.reshape(b, pw, ph, c).permute(0, 2, 1, 3).contiguous()


def prep_on_device(img: torch.Tensor, geom: torch.Tensor, pixel_means,
                   out_bucket: tuple) -> torch.Tensor:
    """Mean-subtract, bilinear-resize and bucket-pad a batch.

    img: (B, H, W, 3) f32 BGR; geom: (B, 5) f32 rows (h0, w0, oh, ow,
    scale) from `tpudenoise.utils.blob.rescale_geometry`."""
    means = torch.as_tensor(pixel_means, dtype=torch.float32,
                            device=img.device).reshape(3)
    g = geom.to(device=img.device, dtype=torch.float32)
    return resize_to_bucket(img - means, g[:, 0], g[:, 1], g[:, 2], g[:, 3],
                            g[:, 4], out_bucket)
