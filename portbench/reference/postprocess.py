"""The detections of a chunk from the detector's outputs, as
tf-faster-rcnn's `test.py` `im_detect` and `test_net` make them: the
boxes decoded from the rois (divided by the image's scale) and the
class deltas, x1/y1 floored at 0 and x2/y2 capped at the original
extent less 1; per foreground class the boxes with score above thresh,
greedy NMS at TEST.NMS keeping at most max_per_class; then the image's
top max_per_image scores over all classes (every score equal to the
cut-off kept)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.arith import Arith
from portbench.reference.detector import decode, greedy_nms


def detections(rois, roi_mask, cls_prob, bbox_pred, im_info, cfg: dict,
               A: Arith) -> list:
    """Per image, per foreground class, an (n, 5) float32 array of
    (x1, y1, x2, y2, score)."""
    out = []
    for i in range(rois.shape[0]):
        scale = im_info[i, 2]
        h0 = torch.round(im_info[i, 0] / scale)
        w0 = torch.round(im_info[i, 1] / scale)
        boxes = A.decode(decode(A.decode(rois[i] / scale),
                                A.decode(bbox_pred[i])))
        x1, y1 = boxes[:, 0::4].clamp(min=0.0), boxes[:, 1::4].clamp(min=0.0)
        x2 = torch.minimum(boxes[:, 2::4], w0 - 1)
        y2 = torch.minimum(boxes[:, 3::4], h0 - 1)
        boxes = torch.stack([x1, y1, x2, y2], -1)          # (R, C, 4)
        probs = A.decode(cls_prob[i])
        per_class = []
        for c in range(1, probs.shape[1]):
            s = probs[:, c]
            valid = roi_mask[i] & (s > cfg['thresh'])
            s = torch.where(valid, s, -np.inf)
            order = torch.sort(s, descending=True, stable=True).indices
            keep = greedy_nms(boxes[order, c], valid[order], cfg['test_nms'],
                              cfg['max_per_image'])
            sel = order[keep]
            per_class.append(torch.cat([boxes[sel, c], probs[sel, c, None]],
                                       1).cpu().numpy().astype(np.float32))
        scores = np.concatenate([d[:, 4] for d in per_class])
        if len(scores) > cfg['max_per_image']:
            cut = np.sort(scores)[-cfg['max_per_image']]
            per_class = [d[d[:, 4] >= cut] for d in per_class]
        out.append(per_class)
    return out
