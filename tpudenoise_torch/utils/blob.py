"""Image geometry helpers (counterpart of `tpudenoise/utils/blob.py`
`rescale_geometry`, `prep_im_for_blob` and `derive_bucket`, and of
`tpudenoise/models/faster_rcnn.py` `pad_to_bucket`).

The min-side/max-side rescale rule and the static padded bucket of the
batched eval harness, in double precision so that im_info equals the
reference's; the host prep (cv2's resize, imported when it is called:
the GPU machine has no cv2).
"""

from __future__ import annotations

import numpy as np


def rescale_geometry(h: int, w: int, target_size: int, max_size: int):
    """(scale, out_h, out_w): scale the short side to target_size unless
    the long side would then exceed max_size; the output size is rounded
    as cv2's dsize is."""
    im_scale = float(target_size) / float(min(h, w))
    if np.round(im_scale * max(h, w)) > max_size:
        im_scale = float(max_size) / float(max(h, w))
    return (im_scale, int(np.round(h * im_scale)),
            int(np.round(w * im_scale)))


def prep_im_for_blob(im: np.ndarray, pixel_means, target_size: int,
                     max_size: int):
    """Mean subtraction, then cv2's bilinear resize by the rescale rule's
    scale, on the host: (image (oh, ow, 3) f32, scale)."""
    import cv2
    im = im.astype(np.float32, copy=False) - pixel_means
    im_scale, _, _ = rescale_geometry(im.shape[0], im.shape[1],
                                      target_size, max_size)
    im = cv2.resize(im, None, None, fx=im_scale, fy=im_scale,
                    interpolation=cv2.INTER_LINEAR)
    return im, im_scale


def pad_to_bucket(im: np.ndarray, bucket=(608, 1024)):
    """Zero-pad (H, W, 3) to the static bucket: (padded, (h, w))."""
    h, w = im.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(f'image {h}x{w} exceeds bucket {bh}x{bw}')
    out = np.zeros((bh, bw, 3), np.float32)
    out[:h, :w] = im
    return out, (h, w)


def _round_up(v: int, m: int = 32) -> int:
    return ((int(v) + m - 1) // m) * m


def derive_bucket(target_size: int, max_size: int,
                  portrait: bool = False) -> tuple:
    """Static padded bucket covering every rescale of the geometry:
    (short, long) for landscape, (long, short) for portrait, rounded up
    to 32."""
    s = _round_up(target_size)
    m = _round_up(max_size)
    return (m, s) if portrait else (s, m)
