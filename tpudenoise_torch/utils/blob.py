"""Image geometry helpers (counterpart of `tpudenoise/utils/blob.py`
`rescale_geometry` and `derive_bucket`).

The min-side/max-side rescale rule and the static padded bucket of the
batched eval harness, in double precision so that im_info equals the
reference's.
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
