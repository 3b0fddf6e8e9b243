"""VOC-layout datasets: PASCAL VOC and the rrData ("person") dataset.

A copy of `tpudenoise/data/voc_like.py` (`VocStyleDataset`, `rrData`,
`pascal_voc`), which the port may not import, on the port's `imdb` base
(`data/imdb.py`): XML annotations, txt image sets, the gt roidb (pickled
under DATA_DIR/cache), per-class VOC results files and the python AP
evaluation (rrData sweeps IoU 0.50:0.05:0.95, ref rrData.py:246-269;
pascal_voc evaluates at 0.5), and the rpn roidb: `config['rpn_file']`, a
pickled list of (N, 4) proposal boxes per image, turned into roidb rows
by `create_roidb_from_box_list` and, for an image set other than `test`,
merged under the gt rows.  Left out: the MATLAB bridge
(`config['matlab_eval']` stays False) and the metrics logger;
`_do_python_eval` prints the APs.

`pixel_dir=...` points `image_path_at` at `.npy` pixels that
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
from tpudenoise_torch.data.imdb import imdb
from tpudenoise_torch.eval.voc_eval import voc_eval

# the VOC-21 classes, the demo's default
VOC_CLASSES = ('__background__', 'aeroplane', 'bicycle', 'bird', 'boat',
               'bottle', 'bus', 'car', 'cat', 'chair', 'cow',
               'diningtable', 'dog', 'horse', 'motorbike', 'person',
               'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


class VocStyleDataset(imdb):
    """Common VOC-layout dataset.  Subclasses define paths and classes.
    With pixel_dir, image i is read from pixel_dir/<index>.npy."""

    def __init__(self, name, image_set, year, classes, config=None,
                 pixel_dir=None):
        super().__init__(name, classes, config)
        self._year = year
        self._image_set = image_set
        self._pixel_dir = pixel_dir
        self._image_ext = '.jpg' if pixel_dir is None else '.npy'
        self._salt = str(uuid.uuid4())
        self._comp_id = 'comp4'
        self.config = {'cleanup': True, 'use_salt': True,
                       'use_diff': False, 'matlab_eval': False,
                       'rpn_file': None}
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb

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

    def rpn_roidb(self):
        """The rpn proposals' roidb, under the gt rows except for the
        `test` image set."""
        if self._image_set != 'test':
            gt = self.gt_roidb()
            return imdb.merge_roidbs(gt, self._load_rpn_roidb(gt))
        return self._load_rpn_roidb(None)

    def _load_rpn_roidb(self, gt_roidb):
        filename = self.config['rpn_file']
        assert filename and osp.exists(filename), \
            f'rpn data not found at: {filename}'
        with open(filename, 'rb') as f:
            box_list = pickle.load(f)
        return self.create_roidb_from_box_list(box_list, gt_roidb)

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

    def _iou_thresholds(self):
        return [0.5]

    def _use_07_metric(self):
        return int(self._year) < 2010

    # ---- loading ----
    def image_stem_at(self, i) -> str:
        """Image i's file name without extension: its index."""
        return self._image_index[i]

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index):
        path = osp.join(self._pixel_dir or self._image_dir(),
                        index + self._image_ext)
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
        name = f'rrData_{year}_{image_set}' + ('_diff' if use_diff else '')
        super().__init__(name, image_set, year,
                         ('__background__', 'person'), config, pixel_dir)

    def _image_dir(self):
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


class pascal_voc(VocStyleDataset):
    """Stock VOC2007/2012 (ref lib/datasets/pascal_voc.py): root
    DATA_DIR/VOCdevkit<year>/VOC<year>, AP at IoU 0.5 with the VOC07
    11-point metric before 2010.  With pixel_dir, image i is read from
    pixel_dir/<index>.npy."""

    def __init__(self, image_set, year, use_diff=False, config=None,
                 pixel_dir=None):
        config = config or default_config()
        self._devkit_path = osp.join(config.DATA_DIR, 'VOCdevkit' + year)
        self._data_path = osp.join(self._devkit_path, 'VOC' + year)
        name = f'voc_{year}_{image_set}' + ('_diff' if use_diff else '')
        super().__init__(name, image_set, year, VOC_CLASSES, config,
                         pixel_dir)
        self.config['use_diff'] = use_diff

    def _image_dir(self):
        return osp.join(self._data_path, 'JPEGImages')

    def _anno_path(self, index='{:s}'):
        return osp.join(self._data_path, 'Annotations', index + '.xml')

    def _image_set_file(self):
        return osp.join(self._data_path, 'ImageSets', 'Main',
                        self._image_set + '.txt')

    def _results_dir(self):
        return osp.join(self._devkit_path, 'results', 'VOC' + self._year,
                        'Main')

    def _cachedir(self):
        return osp.join(self._devkit_path, 'annotations_cache')
