"""VOC-style detection AP evaluation (a copy of
`tpudenoise/eval/voc_eval.py`, which the port may not import).

Reimplements the reference's evaluator (ref lib/datasets/voc_eval.py:15-216)
with the same matching rules: greedy per-detection matching in confidence
order, per-gt dedup, IoU with the +1 convention, 11-point (VOC07) or
continuous AP, and the same annotation cache file.  Vectorized where the
reference loops: each image's detections meet its ground truth in one
array expression, elementwise the reference's arithmetic; the greedy
match (inherently sequential) stays a host loop, over Python scalars.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(filename: str):
    """Parse one PASCAL VOC XML annotation (ref voc_eval.py:15-33)."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall('object'):
        bbox = obj.find('bndbox')
        objects.append({
            'name': obj.find('name').text,
            'bbox': [int(float(bbox.find(k).text))
                     for k in ('xmin', 'ymin', 'xmax', 'ymax')],
        })
    return objects


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve: 11-point (VOC07) or precision-envelope area
    (ref voc_eval.py:36-67)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    # precision envelope
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(detpath: str, annopath: str, imagesetfile: str,
             classname: str, cachedir: str, ovthresh: float = 0.5,
             use_07_metric: bool = False, use_diff: bool = False):
    """rec, prec, ap for one class (ref voc_eval.py:70-216).

    detpath.format(classname): detection txt, lines
    `image_id score x1 y1 x2 y2` (1-based coords, VOC convention).
    """
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(
        cachedir, f'{os.path.basename(imagesetfile)}_annots.pkl')
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f.readlines()]

    if os.path.isfile(cachefile):
        with open(cachefile, 'rb') as f:
            recs = pickle.load(f)
    else:
        recs = {name: parse_rec(annopath.format(name))
                for name in imagenames}
        with open(cachefile, 'wb') as f:
            pickle.dump(recs, f)

    # per-image gt for this class
    class_recs = {}
    npos = 0
    for name in imagenames:
        R = [o for o in recs[name] if o['name'] == classname]
        bbox = np.array([o['bbox'] for o in R])
        difficult = np.zeros(len(R), dtype=bool)  # ref hardcodes False
        npos += int((~difficult).sum())
        class_recs[name] = {'bbox': bbox, 'difficult': difficult,
                            'det': [False] * len(R)}

    detfile = detpath.format(classname)
    with open(detfile) as f:
        lines = [x.strip().split(' ') for x in f.readlines()]
    image_ids = [x[0] for x in lines]
    confidence = np.array([float(x[1]) for x in lines])
    bb_all = np.array([[float(z) for z in x[2:]] for x in lines])

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if bb_all.shape[0] > 0:
        order = np.argsort(-confidence)
        bb_all = bb_all[order]
        image_ids = [image_ids[i] for i in order]
        # each detection's best overlap and its gt: one image's detections
        # against its gts at once, elementwise as the reference's per
        # detection arithmetic (so the same floats)
        ovmax = np.full(nd, -np.inf)
        jmax = np.full(nd, -1)
        of_image = {}
        for d, name in enumerate(image_ids):
            of_image.setdefault(name, []).append(d)
        for name, ds in of_image.items():
            gts = class_recs[name]['bbox'].astype(float)
            if gts.size == 0:
                continue
            bb = bb_all[ds][:, None, :]                         # (n, 1, 4)
            ixmin = np.maximum(gts[:, 0], bb[..., 0])
            iymin = np.maximum(gts[:, 1], bb[..., 1])
            ixmax = np.minimum(gts[:, 2], bb[..., 2])
            iymax = np.minimum(gts[:, 3], bb[..., 3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[..., 2] - bb[..., 0] + 1.0)
                   * (bb[..., 3] - bb[..., 1] + 1.0)
                   + (gts[:, 2] - gts[:, 0] + 1.0)
                   * (gts[:, 3] - gts[:, 1] + 1.0) - inters)
            overlaps = inters / uni                             # (n, G)
            ovmax[ds] = overlaps.max(axis=1)
            jmax[ds] = overlaps.argmax(axis=1)
        # the greedy match in confidence order: sequential, on scalars
        for d, (ov, j, name) in enumerate(zip(ovmax.tolist(), jmax.tolist(),
                                              image_ids)):
            R = class_recs[name]
            if ov > ovthresh:
                if not R['difficult'][j]:
                    if not R['det'][j]:
                        tp[d] = 1.0
                        R['det'][j] = True
                    else:
                        fp[d] = 1.0
            else:
                fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap
