"""The image database (imdb) base (counterpart of `tpudenoise/data/imdb.py`,
which the port may not import): name, classes, the roidb and its handler
(`set_proposal_method(name)` picks `<name>_roidb`), horizontal flips
(`append_flipped_images`, widths from `utils.image_io.image_hw`),
proposal recall (`evaluate_recall`), proposal roidbs
(`create_roidb_from_box_list`), `merge_roidbs`, `competition_mode` and the
cache directory DATA_DIR/cache.

Each roidb entry is {boxes (N, 4) 0-based, gt_classes (N,), gt_overlaps
(N, C), flipped, seg_areas}.  The IoU matrices of the proposal methods go
through `ops.boxes.bbox_overlaps` in f32 on `self.device` (`cuda` unless
the caller sets it to 'cpu'); the greedy matching stays on the host.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.utils.image_io import image_hw


class imdb:
    def __init__(self, name: str, classes=None, config=None):
        self._name = name
        self._classes = list(classes) if classes else []
        self._image_index = []
        self._roidb = None
        self._roidb_handler = self.default_roidb
        self._cfg = config or default_config()
        self.config = {}
        # where the proposal methods' IoU matrices run
        self.device = 'cuda'

    # ---- identity ----
    @property
    def name(self):
        return self._name

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    @property
    def cache_path(self):
        path = osp.join(self._cfg.DATA_DIR, 'cache')
        os.makedirs(path, exist_ok=True)
        return path

    # ---- roidb ----
    @property
    def roidb_handler(self):
        return self._roidb_handler

    @roidb_handler.setter
    def roidb_handler(self, v):
        self._roidb_handler = v

    def set_proposal_method(self, method: str):
        """The roidb handler `<method>_roidb` ('gt', 'rpn'); an unknown
        method raises AttributeError."""
        self._roidb_handler = getattr(self, method + '_roidb')

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self._roidb_handler()
        return self._roidb

    def default_roidb(self):
        raise NotImplementedError

    def gt_roidb(self):
        raise NotImplementedError

    def image_path_at(self, i: int) -> str:
        raise NotImplementedError

    def evaluate_detections(self, all_boxes, output_dir):
        raise NotImplementedError

    def competition_mode(self, on: bool):
        pass

    # ---- augmentation ----
    def append_flipped_images(self):
        """Append a horizontally flipped copy of every entry and double
        the image index."""
        num_images = self.num_images
        widths = [image_hw(self.image_path_at(i))[1]
                  for i in range(num_images)]
        for i in range(num_images):
            boxes = self.roidb[i]['boxes'].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - oldx2 - 1
            boxes[:, 2] = widths[i] - oldx1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            self.roidb.append({'boxes': boxes,
                               'gt_overlaps': self.roidb[i]['gt_overlaps'],
                               'gt_classes': self.roidb[i]['gt_classes'],
                               'seg_areas': self.roidb[i]['seg_areas'],
                               'flipped': True})
        self._image_index = self._image_index * 2

    def _overlaps(self, boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
        """(N, K) f32 IoU of boxes against query, on self.device."""
        from tpudenoise_torch.ops.boxes import bbox_overlaps

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, np.float32)).to(self.device)
        return bbox_overlaps(dev(boxes), dev(query)).cpu().numpy()

    # ---- proposal recall ----
    def evaluate_recall(self, candidate_boxes=None, thresholds=None,
                        area='all', limit=None):
        """Proposal recall over IoU thresholds (default 0.5:0.05:0.95) for
        the gt boxes of an area range: each gt box greedily takes its best
        unclaimed candidate (candidate_boxes[i], else the roidb's non-gt
        rows, the first `limit` of them).  Returns {'ar', 'recalls',
        'thresholds', 'gt_overlaps'}."""
        areas = {'all': 0, 'small': 1, 'medium': 2, 'large': 3,
                 '96-128': 4, '128-256': 5, '256-512': 6, '512-inf': 7}
        area_ranges = [[0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2],
                       [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2],
                       [96 ** 2, 128 ** 2], [128 ** 2, 256 ** 2],
                       [256 ** 2, 512 ** 2], [512 ** 2, 1e5 ** 2]]
        if area not in areas:
            # AssertionError, as the JAX package's assert raises
            raise AssertionError(f'unknown area range {area!r}')
        area_range = area_ranges[areas[area]]
        gt_overlaps = np.zeros(0)
        num_pos = 0
        for i in range(self.num_images):
            entry = self.roidb[i]
            max_gt = entry['gt_overlaps'].max(axis=1)
            gt_inds = np.where((entry['gt_classes'] > 0) & (max_gt == 1))[0]
            gt_boxes = entry['boxes'][gt_inds, :]
            gt_areas = entry['seg_areas'][gt_inds]
            valid = np.where((gt_areas >= area_range[0])
                             & (gt_areas <= area_range[1]))[0]
            gt_boxes = gt_boxes[valid, :]
            num_pos += len(valid)
            if candidate_boxes is None:
                boxes = entry['boxes'][entry['gt_classes'] == 0, :]
            else:
                boxes = candidate_boxes[i]
            if boxes.shape[0] == 0 or gt_boxes.shape[0] == 0:
                continue
            if limit is not None and boxes.shape[0] > limit:
                boxes = boxes[:limit, :]
            overlaps = self._overlaps(boxes, gt_boxes)
            _gt = np.zeros((gt_boxes.shape[0]))
            for j in range(gt_boxes.shape[0]):
                argmax = overlaps.argmax(axis=0)
                maxov = overlaps.max(axis=0)
                gt_ind = maxov.argmax()
                _gt[j] = maxov.max()
                assert _gt[j] >= 0
                overlaps[argmax[gt_ind], :] = -1
                overlaps[:, gt_ind] = -1
            gt_overlaps = np.hstack((gt_overlaps, _gt))
        gt_overlaps = np.sort(gt_overlaps)
        if thresholds is None:
            thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        recalls = np.zeros_like(thresholds)
        for i, t in enumerate(thresholds):
            recalls[i] = (gt_overlaps >= t).sum() / float(num_pos)
        return {'ar': recalls.mean(), 'recalls': recalls,
                'thresholds': thresholds, 'gt_overlaps': gt_overlaps}

    # ---- proposal roidbs ----
    def create_roidb_from_box_list(self, box_list, gt_roidb):
        """One roidb entry per image from its (N, 4) proposal boxes: class
        0, zero seg areas, and each box's best IoU with a gt box (if any)
        in that box's class column of gt_overlaps."""
        assert len(box_list) == self.num_images
        roidb = []
        for i in range(self.num_images):
            boxes = box_list[i]
            num_boxes = boxes.shape[0]
            overlaps = np.zeros((num_boxes, self.num_classes),
                                dtype=np.float32)
            if gt_roidb is not None and gt_roidb[i]['boxes'].size > 0:
                gt_classes = gt_roidb[i]['gt_classes']
                ov = self._overlaps(boxes, gt_roidb[i]['boxes'])
                argmaxes = ov.argmax(axis=1)
                maxes = ov.max(axis=1)
                pos = np.where(maxes > 0)[0]
                overlaps[pos, gt_classes[argmaxes[pos]]] = maxes[pos]
            roidb.append({
                'boxes': boxes,
                'gt_classes': np.zeros((num_boxes,), dtype=np.int32),
                'gt_overlaps': overlaps,
                'flipped': False,
                'seg_areas': np.zeros((num_boxes,), dtype=np.float32),
            })
        return roidb

    @staticmethod
    def merge_roidbs(a, b):
        assert len(a) == len(b)
        for i in range(len(a)):
            a[i]['boxes'] = np.vstack((a[i]['boxes'], b[i]['boxes']))
            a[i]['gt_classes'] = np.hstack((a[i]['gt_classes'],
                                            b[i]['gt_classes']))
            a[i]['gt_overlaps'] = np.vstack((a[i]['gt_overlaps'],
                                             b[i]['gt_overlaps']))
            a[i]['seg_areas'] = np.hstack((a[i]['seg_areas'],
                                           b[i]['seg_areas']))
        return a
