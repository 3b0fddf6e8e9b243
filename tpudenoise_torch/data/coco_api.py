"""The in-repo COCO API (a copy of `tpudenoise/data/coco_api.py`, which the
port may not import): the subset of pycocotools that `data/coco.py` drives
(annotation-file indexing, `COCO`) and a bbox-only `COCOeval` (AP averaged
over IoU 0.50:0.05:0.95, area ranges, maxDets, the 101-point interpolated
PR curve, the 12-number `stats`), in numpy and json.  The GPU machine has
no pycocotools, so the port always uses this one, as the JAX package does
where pycocotools is absent; `tests/test_torch_coco.py` holds the two
copies' `stats` equal.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {'all': (0.0, 1e10), 'small': (0.0, 32.0 ** 2),
            'medium': (32.0 ** 2, 96.0 ** 2), 'large': (96.0 ** 2, 1e10)}
MAX_DETS = (1, 10, 100)


class COCO:
    """Annotation-file index with the pycocotools method names."""

    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.create_index()

    def create_index(self):
        self.anns = {a['id']: a for a in self.dataset.get('annotations', [])}
        self.imgs = {i['id']: i for i in self.dataset.get('images', [])}
        self.cats = {c['id']: c for c in self.dataset.get('categories', [])}
        self.img_to_anns = defaultdict(list)
        for a in self.dataset.get('annotations', []):
            self.img_to_anns[a['image_id']].append(a)

    # --- query API (subset used by data/coco.py) ---

    def getCatIds(self, catNms=()):
        ids = [c['id'] for c in self.dataset.get('categories', [])
               if not catNms or c['name'] in catNms]
        return ids

    def loadCats(self, ids):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.cats[i] for i in ids]

    def getImgIds(self):
        return list(self.imgs.keys())

    def loadImgs(self, ids):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds=(), catIds=(), iscrowd=None):
        imgIds = (imgIds if isinstance(imgIds, (list, tuple))
                  else [imgIds])
        catIds = (catIds if isinstance(catIds, (list, tuple))
                  else [catIds])
        anns = (sum((self.img_to_anns[i] for i in imgIds), [])
                if imgIds else list(self.anns.values()))
        if catIds:
            anns = [a for a in anns if a['category_id'] in catIds]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get('iscrowd')) == iscrowd]
        return [a['id'] for a in anns]

    def loadAnns(self, ids):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def loadRes(self, res_file):
        """Detection results (json list of {image_id, category_id, bbox
        xywh, score}) -> a COCO object sharing this one's images/cats."""
        res = COCO()
        res.dataset = {'images': list(self.imgs.values()),
                       'categories': copy.deepcopy(
                           self.dataset.get('categories', []))}
        if isinstance(res_file, str):
            with open(res_file) as f:
                dets = json.load(f)
        else:
            dets = res_file
        anns = []
        for i, d in enumerate(dets):  # copies: never mutate the input
            x, y, w, h = d['bbox']
            d = dict(d)
            d.setdefault('id', i + 1)
            d.setdefault('area', float(w * h))
            d.setdefault('iscrowd', 0)
            anns.append(d)
        res.dataset['annotations'] = anns
        res.create_index()
        return res


def _bbox_iou(dts: np.ndarray, gts: np.ndarray,
              crowd: np.ndarray) -> np.ndarray:
    """IoU of xywh boxes; vs a crowd gt the denominator is the dt area
    only (a detection inside a crowd region is fully covered)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(min=0)
    ih = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(min=0)
    inter = iw * ih
    da = (dts[:, 2] * dts[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(crowd[None], da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


class COCOeval:
    """bbox-only COCO detection evaluation (evaluate/accumulate/summarize,
    the standard 12-number summary)."""

    def __init__(self, cocoGt: COCO, cocoDt: COCO, iouType: str = 'bbox'):
        assert iouType == 'bbox', 'only bbox evaluation is implemented'
        self.gt, self.dt = cocoGt, cocoDt
        self.img_ids = sorted(cocoGt.getImgIds())
        self.cat_ids = sorted(cocoGt.getCatIds())
        self.stats = None
        self._per_img = {}
        self._fetch_cache = {}
        self.eval = {}

    def _fetch(self, img_id, cat_id):
        """Anns + score-sorted dts + IoU matrix for one (image, category),
        computed ONCE and reused across the 4 area ranges (pycocotools
        likewise caches computeIoU; recomputing per range made the
        pure-python fallback 4x slower than it already is)."""
        key = (img_id, cat_id)
        if key not in self._fetch_cache:
            gts = [self.gt.anns[i] for i in
                   self.gt.getAnnIds(imgIds=[img_id], catIds=[cat_id])]
            dts = [self.dt.anns[i] for i in
                   self.dt.getAnnIds(imgIds=[img_id], catIds=[cat_id])]
            dts = sorted(dts, key=lambda d: -d['score'])[:max(MAX_DETS)]
            crowd = np.array([bool(g.get('iscrowd')) for g in gts], bool)
            ious = _bbox_iou(
                np.array([d['bbox'] for d in dts],
                         np.float64).reshape(-1, 4),
                np.array([g['bbox'] for g in gts],
                         np.float64).reshape(-1, 4),
                crowd)
            self._fetch_cache[key] = (gts, dts, ious)
        return self._fetch_cache[key]

    def _match_one(self, img_id, cat_id, lo, hi):
        """Greedy matching for ONE area range: gts outside [lo, hi] (or
        crowd) are ignore-flagged and sorted last, so in-range gts win the
        match even when an out-of-range gt overlaps better — the standard
        per-range re-matching (only the 'all' range would survive a
        single global match)."""
        gts0, dts, ious0 = self._fetch(img_id, cat_id)

        def area(g):
            return g.get('area', g['bbox'][2] * g['bbox'][3])

        def ignored(g):
            return (bool(g.get('iscrowd')) or area(g) < lo
                    or area(g) > hi)

        # ignored gts sort last so real gts win ties; permute the cached
        # IoU columns instead of recomputing (crowd handling is per-gt,
        # so column permutation is exact)
        order = sorted(range(len(gts0)), key=lambda gi: ignored(gts0[gi]))
        gts = [gts0[gi] for gi in order]
        crowd = np.array([bool(g.get('iscrowd')) for g in gts], bool)
        g_ig = np.array([ignored(g) for g in gts], bool)
        ious = ious0[:, order] if len(gts0) else ious0
        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_match = np.zeros((T, D), np.int64)     # 1 + matched gt index
        gt_match = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)             # matched an ignored gt
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best, m = min(t, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_match[ti, gi] and not crowd[gi]:
                        continue
                    if m > -1 and not g_ig[m] and g_ig[gi]:
                        break  # only ignored gts remain; keep real match
                    if ious[di, gi] < best:
                        continue
                    best, m = ious[di, gi], gi
                if m >= 0:
                    dt_match[ti, di] = m + 1
                    gt_match[ti, m] = di + 1
                    dt_ig[ti, di] = g_ig[m]
        return {'scores': np.array([d['score'] for d in dts], np.float64),
                'dt_area': np.array([d['bbox'][2] * d['bbox'][3]
                                     for d in dts], np.float64),
                'dt_match': dt_match, 'dt_ig': dt_ig,
                'n_gt': int((~g_ig).sum())}

    def evaluate(self):
        if len(self.img_ids) * len(self.cat_ids) > 100_000:
            print('WARNING: the numpy COCO eval on '
                  f'{len(self.img_ids)} images x {len(self.cat_ids)} '
                  'categories: this is slow at full-COCO scale.')
        for img_id in self.img_ids:
            # evict the previous image's gts/dts/IoU tuples: reuse only
            # happens within one image (across its cats x 4 area ranges);
            # retaining all images x cats exhausts memory at full-COCO
            # scale
            self._fetch_cache.clear()
            for cat_id in self.cat_ids:
                for rng_name, (lo, hi) in AREA_RNG.items():
                    self._per_img[img_id, cat_id, rng_name] = \
                        self._match_one(img_id, cat_id, lo, hi)

    def accumulate(self):
        T, K = len(IOU_THRS), len(self.cat_ids)
        A, M = len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, len(RECALL_THRS), K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat_id in enumerate(self.cat_ids):
            for ai, (rng_name, (lo, hi)) in enumerate(AREA_RNG.items()):
                for mi, max_det in enumerate(MAX_DETS):
                    scores, tps, fps, npig = [], [], [], 0
                    for img_id in self.img_ids:
                        e = self._per_img[img_id, cat_id, rng_name]
                        npig += e['n_gt']
                        n = min(max_det, len(e['scores']))
                        if n == 0:
                            continue
                        m = e['dt_match'][:, :n]
                        # a dt is ignored if it matched an ignored gt, or
                        # is unmatched and outside the area range
                        d_out = ((e['dt_area'][:n] < lo)
                                 | (e['dt_area'][:n] > hi))
                        d_ig = (e['dt_ig'][:, :n]
                                | ((m == 0) & d_out[None]))
                        scores.append(e['scores'][:n])
                        tps.append((m > 0) & ~d_ig)
                        fps.append((m == 0) & ~d_ig)
                    if npig == 0:
                        continue
                    if scores:
                        sc = np.concatenate(scores)
                        order = np.argsort(-sc, kind='mergesort')
                        tp = np.cumsum(np.concatenate(tps, 1)[:, order], 1)
                        fp = np.cumsum(np.concatenate(fps, 1)[:, order], 1)
                    else:
                        tp = fp = np.zeros((T, 0))
                    for ti in range(T):
                        tpc, fpc = tp[ti], fp[ti]
                        rc = tpc / npig
                        pr = tpc / np.maximum(tpc + fpc, 1e-10)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope then sample at 101 recalls
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rc, RECALL_THRS, side='left')
                        q = np.zeros(len(RECALL_THRS))
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = {'precision': precision, 'recall': recall}

    def _summary(self, ap=True, iou=None, area='all', max_det=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.eval['precision'][..., ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        else:
            s = self.eval['recall'][:, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def summarize(self):
        p = [
            ('AP @[.50:.95 | all | 100]', self._summary(True)),
            ('AP @[.50      | all | 100]', self._summary(True, 0.5)),
            ('AP @[.75      | all | 100]', self._summary(True, 0.75)),
            ('AP @[.50:.95 | small]', self._summary(True, area='small')),
            ('AP @[.50:.95 | medium]', self._summary(True, area='medium')),
            ('AP @[.50:.95 | large]', self._summary(True, area='large')),
            ('AR @[.50:.95 | all | 1]', self._summary(False, max_det=1)),
            ('AR @[.50:.95 | all | 10]', self._summary(False, max_det=10)),
            ('AR @[.50:.95 | all | 100]', self._summary(False)),
            ('AR @[.50:.95 | small]', self._summary(False, area='small')),
            ('AR @[.50:.95 | medium]', self._summary(False,
                                                     area='medium')),
            ('AR @[.50:.95 | large]', self._summary(False, area='large')),
        ]
        self.stats = np.array([v for _, v in p])
        for name, v in p:
            print(f' {name:32s} = {v:.3f}')
