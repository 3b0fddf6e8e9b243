"""The COCO dataset (counterpart of `tpudenoise/data/coco.py`, ref
lib/datasets/coco.py:27-316) on the port's `imdb` base and its in-repo
COCO API (`data/coco_api.py`; the GPU machine has no pycocotools).

The gt roidb comes from DATA_DIR/coco/annotations/instances_<split><year>
.json (image_info_... for the test splits); `image_path_at` uses the
reference's file names, DATA_DIR/coco/images/<view>/COCO_<view>_<id
:012d>.jpg, or `<pixel_dir>/<stem>.npy` with a pixel_dir of cached
pixels.  `evaluate_detections` writes the results json, runs COCOeval
(evaluate, accumulate, summarize) and pickles it as
detection_results.pkl; it returns None, as the JAX package's does.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np

from tpudenoise_torch.data.coco_api import COCO, COCOeval
from tpudenoise_torch.data.imdb import imdb


class coco(imdb):
    def __init__(self, image_set, year, config=None, pixel_dir=None):
        super().__init__(f'coco_{year}_{image_set}', config=config)
        self._year = year
        self._image_set = image_set
        self._pixel_dir = pixel_dir
        self._data_path = osp.join(self._cfg.DATA_DIR, 'coco')
        self._COCO = COCO(self._get_ann_file())
        cats = self._COCO.loadCats(self._COCO.getCatIds())
        self._classes = tuple(['__background__']
                              + [c['name'] for c in cats])
        self._class_to_coco_cat_id = dict(
            zip([c['name'] for c in cats], self._COCO.getCatIds()))
        self._image_index = self._COCO.getImgIds()
        self._roidb_handler = self.gt_roidb
        self._view_map = {'minival2014': 'val2014',
                          'valminusminival2014': 'val2014',
                          'test-dev2015': 'test2015'}
        coco_name = image_set + year
        self._data_name = self._view_map.get(coco_name, coco_name)

    def _get_ann_file(self):
        prefix = ('instances' if self._image_set.find('test') == -1
                  else 'image_info')
        return osp.join(self._data_path, 'annotations',
                        f'{prefix}_{self._image_set}{self._year}.json')

    def image_stem_at(self, i) -> str:
        """Image i's file name without extension."""
        return f'COCO_{self._data_name}_{self._image_index[i]:012d}'

    def image_path_at(self, i):
        if self._pixel_dir is not None:
            return osp.join(self._pixel_dir, self.image_stem_at(i) + '.npy')
        return osp.join(self._data_path, 'images', self._data_name,
                        self.image_stem_at(i) + '.jpg')

    def gt_roidb(self):
        cache_file = osp.join(self.cache_path, self.name + '_gt_roidb.pkl')
        if osp.exists(cache_file):
            with open(cache_file, 'rb') as f:
                return pickle.load(f)
        roidb = [self._load_coco_annotation(i) for i in self._image_index]
        with open(cache_file, 'wb') as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_coco_annotation(self, index):
        """One image's annotations as a roidb entry: xywh boxes clipped
        to the image as x1y1x2y2 (the reference's -1 width convention),
        empty or degenerate ones dropped, crowd rows with -1 overlaps."""
        im_ann = self._COCO.loadImgs(index)[0]
        width, height = im_ann['width'], im_ann['height']
        ann_ids = self._COCO.getAnnIds(imgIds=index, iscrowd=None)
        objs = self._COCO.loadAnns(ann_ids)
        valid = []
        for obj in objs:
            x1 = max(0, obj['bbox'][0])
            y1 = max(0, obj['bbox'][1])
            x2 = min(width - 1, x1 + max(0, obj['bbox'][2] - 1))
            y2 = min(height - 1, y1 + max(0, obj['bbox'][3] - 1))
            if obj['area'] > 0 and x2 >= x1 and y2 >= y1:
                obj['clean_bbox'] = [x1, y1, x2, y2]
                valid.append(obj)
        num = len(valid)
        boxes = np.zeros((num, 4), dtype=np.uint16)
        gt_classes = np.zeros((num,), dtype=np.int32)
        overlaps = np.zeros((num, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros((num,), dtype=np.float32)
        cat_to_class = dict(
            [(self._class_to_coco_cat_id[c], i)
             for i, c in enumerate(self._classes[1:], start=1)])
        for ix, obj in enumerate(valid):
            cls = cat_to_class[obj['category_id']]
            boxes[ix] = obj['clean_bbox']
            gt_classes[ix] = cls
            seg_areas[ix] = obj['area']
            if obj.get('iscrowd'):
                overlaps[ix, :] = -1.0
            else:
                overlaps[ix, cls] = 1.0
        return {'boxes': boxes, 'gt_classes': gt_classes,
                'gt_overlaps': overlaps, 'flipped': False,
                'seg_areas': seg_areas}

    def evaluate_detections(self, all_boxes, output_dir):
        res_file = osp.join(output_dir,
                            f'detections_{self._image_set}'
                            f'{self._year}_results.json')
        self._write_coco_results_file(all_boxes, res_file)
        if self._image_set.find('test') == -1:
            self._do_detection_eval(res_file, output_dir)

    def _write_coco_results_file(self, all_boxes, res_file):
        results = []
        for cls_ind, cls in enumerate(self.classes):
            if cls == '__background__':
                continue
            cat_id = self._class_to_coco_cat_id[cls]
            for im_ind, index in enumerate(self._image_index):
                dets = np.asarray(all_boxes[cls_ind][im_ind])
                if dets.size == 0:
                    continue
                xs, ys = dets[:, 0], dets[:, 1]
                ws = dets[:, 2] - xs + 1
                hs = dets[:, 3] - ys + 1
                results.extend(
                    [{'image_id': int(index), 'category_id': int(cat_id),
                      'bbox': [float(xs[k]), float(ys[k]), float(ws[k]),
                               float(hs[k])],
                      'score': float(dets[k, -1])}
                     for k in range(dets.shape[0])])
        with open(res_file, 'w') as f:
            json.dump(results, f)

    def _do_detection_eval(self, res_file, output_dir):
        coco_dt = self._COCO.loadRes(res_file)
        coco_eval = COCOeval(self._COCO, coco_dt, 'bbox')
        coco_eval.evaluate()
        coco_eval.accumulate()
        coco_eval.summarize()
        with open(osp.join(output_dir, 'detection_results.pkl'),
                  'wb') as f:
            pickle.dump(coco_eval, f, pickle.HIGHEST_PROTOCOL)
