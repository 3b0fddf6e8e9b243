"""VOC-layout datasets: the rrData ("person") dataset.

A copy of `tpudenoise/data/voc_like.py` (`VocStyleDataset`, `rrData`) and
of the training half of `tpudenoise/data/imdb.py`, which the port may not
import: XML annotations, txt image sets, the gt roidb (pickled under
DATA_DIR/cache), horizontal flips (`append_flipped_images`, widths from
`utils.image_io.image_hw`), `merge_roidbs`, per-class VOC results files
and the python AP evaluation (rrData sweeps IoU 0.50:0.05:0.95, ref
rrData.py:246-269).  Left out: rpn/proposal roidbs, proposal recall, the
MATLAB bridge and the metrics logger; `_do_python_eval` prints the APs.

`rrData(..., pixel_dir=...)` points `image_path_at` at `.npy` pixels that
`tpudenoise_torch.data.cache_pixels` decoded from the JPEGs, which the GPU
machine (no cv2, no PIL) reads through `utils.image_io`.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import uuid
import xml.etree.ElementTree as ET

import numpy as np

from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.eval.voc_eval import voc_eval
from tpudenoise_torch.utils.image_io import image_hw

# the VOC-21 classes, the demo's default
VOC_CLASSES = ('__background__', 'aeroplane', 'bicycle', 'bird', 'boat',
               'bottle', 'bus', 'car', 'cat', 'chair', 'cow',
               'diningtable', 'dog', 'horse', 'motorbike', 'person',
               'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


class VocStyleDataset:
    """Common VOC-layout dataset (the imdb protocol the harness reads:
    `name`, `num_classes`, `num_images`, `image_path_at`,
    `evaluate_detections`).  Subclasses define paths and classes."""

    def __init__(self, name, image_set, year, classes, config=None):
        self._cfg = config or default_config()
        self._name = name
        self._classes = list(classes)
        self._year = year
        self._image_set = image_set
        self._image_ext = '.jpg'
        self._salt = str(uuid.uuid4())
        self._comp_id = 'comp4'
        self.config = {'cleanup': True, 'use_salt': True,
                       'use_diff': False}
        self._image_index = self._load_image_set_index()
        self._roidb = None
        self._roidb_handler = self.gt_roidb

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

    def gt_roidb(self):
        """Each image's annotation as a roidb entry, cached as a pickle in
        DATA_DIR/cache (the JAX package's file name and layout)."""
        cache_file = osp.join(self.cache_path, self.name + '_gt_roidb.pkl')
        if osp.exists(cache_file):
            with open(cache_file, 'rb') as f:
                return pickle.load(f)
        roidb = [self._load_annotation(i) for i in self.image_index]
        with open(cache_file, 'wb') as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_annotation(self, index):
        """VOC XML -> roidb entry with 0-based boxes."""
        tree = ET.parse(self._anno_path(index))
        objs = tree.findall('object')
        if not self.config['use_diff']:
            objs = [o for o in objs
                    if o.find('difficult') is None
                    or int(o.find('difficult').text) == 0]
        num = len(objs)
        boxes = np.zeros((num, 4), dtype=np.uint16)
        gt_classes = np.zeros((num,), dtype=np.int32)
        overlaps = np.zeros((num, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros((num,), dtype=np.float32)
        cls_map = {c: i for i, c in enumerate(self.classes)}
        for ix, obj in enumerate(objs):
            bb = obj.find('bndbox')
            x1 = float(bb.find('xmin').text) - 1
            y1 = float(bb.find('ymin').text) - 1
            x2 = float(bb.find('xmax').text) - 1
            y2 = float(bb.find('ymax').text) - 1
            cls = cls_map[obj.find('name').text.lower().strip()]
            boxes[ix] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)
        return {'boxes': boxes, 'gt_classes': gt_classes,
                'gt_overlaps': overlaps, 'flipped': False,
                'seg_areas': seg_areas}

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

    # ---- path schema and AP rules (defined per dataset) ----
    def _image_dir(self):
        raise NotImplementedError

    def _anno_path(self, index=None):
        raise NotImplementedError

    def _image_set_file(self):
        raise NotImplementedError

    def _results_dir(self):
        raise NotImplementedError

    def _cachedir(self):
        raise NotImplementedError

    # ---- loading ----
    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index):
        path = osp.join(self._image_dir(), index + self._image_ext)
        assert osp.exists(path), f'Path does not exist: {path}'
        return path

    def _load_image_set_index(self):
        path = self._image_set_file()
        assert osp.exists(path), f'Path does not exist: {path}'
        with open(path) as f:
            return [x.strip() for x in f.readlines()]

    # ---- results + evaluation ----
    def _get_comp_id(self):
        return (f'{self._comp_id}_{self._salt}'
                if self.config['use_salt'] else self._comp_id)

    def _results_template(self):
        filedir = self._results_dir()
        os.makedirs(filedir, exist_ok=True)
        return osp.join(
            filedir,
            f'{self._get_comp_id()}_det_{self._image_set}_{{:s}}.txt')

    def _write_voc_results_file(self, all_boxes):
        for cls_ind, cls in enumerate(self.classes):
            if cls == '__background__':
                continue
            filename = self._results_template().format(cls)
            with open(filename, 'w') as f:
                for im_ind, index in enumerate(self.image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        # VOCdevkit expects 1-based coords
                        f.write(f'{index} {dets[k, -1]:.3f} '
                                f'{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} '
                                f'{dets[k, 2] + 1:.1f} '
                                f'{dets[k, 3] + 1:.1f}\n')

    def _do_python_eval(self, output_dir='output'):
        os.makedirs(output_dir, exist_ok=True)
        annopath = self._anno_path()
        imagesetfile = self._image_set_file()
        use_07 = self._use_07_metric()
        aps = []
        for cls in self.classes:
            if cls == '__background__':
                continue
            filename = self._results_template().format(cls)
            for thr in self._iou_thresholds():
                rec, prec, ap = voc_eval(
                    filename, annopath, imagesetfile, cls,
                    self._cachedir(), ovthresh=thr, use_07_metric=use_07,
                    use_diff=self.config['use_diff'])
                aps.append(ap)
                print(f'AP for {cls} with IoU threshold {thr} = {ap:.4f}')
                with open(osp.join(output_dir, cls + '_pr.pkl'),
                          'wb') as f:
                    pickle.dump({'rec': rec, 'prec': prec, 'ap': ap}, f)
        mean_ap = float(np.mean(aps))
        print(f'Mean AP = {mean_ap:.4f}')
        if len(self._iou_thresholds()) > 1:
            print(f'AP@.5 = {aps[0]:.4f}, AP@[.5, .95] = {mean_ap:.4f}')
        return aps

    def evaluate_detections(self, all_boxes, output_dir):
        self._write_voc_results_file(all_boxes)
        aps = self._do_python_eval(output_dir)
        if self.config['cleanup']:
            for cls in self.classes:
                if cls == '__background__':
                    continue
                os.remove(self._results_template().format(cls))
        return aps

    def competition_mode(self, on):
        self.config['use_salt'] = not on
        self.config['cleanup'] = not on


class rrData(VocStyleDataset):
    """The custom single-class person dataset rrData / 6thfloorData
    (ref lib/datasets/rrData.py): root DATA_DIR/6thfloorData/6thFloorTest,
    annotations under Annotations_cvat/6thFloorTest/, AP swept over IoU
    0.50:0.05:0.95 (rrData.py:246-254).  With pixel_dir, image i is
    read from pixel_dir/<index>.npy."""

    def __init__(self, image_set, year='2021', use_diff=False,
                 config=None, pixel_dir=None):
        config = config or default_config()
        self._devkit_path = osp.join(config.DATA_DIR, '6thfloorData')
        self._data_path = osp.join(self._devkit_path, '6thFloorTest')
        self._pixel_dir = pixel_dir
        name = f'rrData_{year}_{image_set}' + ('_diff' if use_diff else '')
        super().__init__(name, image_set, year,
                         ('__background__', 'person'), config)
        if pixel_dir is not None:
            self._image_ext = '.npy'

    def _image_dir(self):
        if self._pixel_dir is not None:
            return self._pixel_dir
        return osp.join(self._data_path, 'JPEGImages')

    def _anno_path(self, index='{:s}'):
        return osp.join(self._data_path, 'Annotations_cvat', '6thFloorTest',
                        'Annotations', index + '.xml')

    def _image_set_file(self):
        return osp.join(self._data_path, 'Annotations_cvat', '6thFloorTest',
                        'ImageSets', 'Main', self._image_set + '.txt')

    def _results_dir(self):
        return osp.join(self._data_path, 'results')

    def _cachedir(self):
        return osp.join(self._devkit_path, 'annotations_cache')

    def _iou_thresholds(self):
        return [0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 0.95]

    def _use_07_metric(self):
        return int(self._year) < 2022  # rrData.py:243
