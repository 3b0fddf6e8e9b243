"""The image database (imdb) base (counterpart of `tpudenoise/data/imdb.py`,
which the port may not import): name, classes, the roidb and its handler,
horizontal flips (`append_flipped_images`, widths from
`utils.image_io.image_hw`), `merge_roidbs`, `competition_mode` and the
cache directory DATA_DIR/cache.

Each roidb entry is {boxes (N, 4) 0-based, gt_classes (N,), gt_overlaps
(N, C), flipped, seg_areas}.  Proposal recall, `create_roidb_from_box_list`
and the rpn roidbs are not ported: only the gt roidb is a proposal method.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

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
        if method != 'gt':
            raise NotImplementedError(
                f'proposal method {method!r}: only the gt roidb is ported')
        self._roidb_handler = self.gt_roidb

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
