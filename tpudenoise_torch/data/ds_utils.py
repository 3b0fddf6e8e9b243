"""Box list filters and validators (counterpart of
`tpudenoise/data/ds_utils.py`, ref lib/datasets/ds_utils.py:13-49)."""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Indices of unique boxes (hash on scaled integer coords)."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """(x, y, w, h) -> (x1, y1, x2, y2) with the +1 convention."""
    return np.hstack((boxes[:, 0:2], boxes[:, 0:2] + boxes[:, 2:4] - 1))


def xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    return np.hstack((boxes[:, 0:2], boxes[:, 2:4] - boxes[:, 0:2] + 1))


def validate_boxes(boxes: np.ndarray, width: int = 0, height: int = 0):
    """Assert boxes are well formed and inside the image."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    assert (x1 >= 0).all()
    assert (y1 >= 0).all()
    assert (x2 >= x1).all()
    assert (y2 >= y1).all()
    assert (x2 < width).all()
    assert (y2 < height).all()


def filter_small_boxes(boxes: np.ndarray, min_size: float) -> np.ndarray:
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.where((w >= min_size) & (h >= min_size))[0]
