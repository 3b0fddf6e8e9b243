"""A synthetic rrData-layout dataset written with numpy alone.

The layout and the annotations are those of `tests/fixtures.py`
(`make_rrdata_fixture`): DATA_DIR/6thfloorData/6thFloorTest with VOC XML
'person' boxes and the txt image set; the pixels are `.npy` files (no
JPEG, so no cv2): a textured background with filled rectangles, drawn by
slicing.  `rrData(image_set, config=cfg, pixel_dir=...)` reads it.

`write_rrdata_fixture` writes the noise grid's dataset: the train and
test splits of `make_rrdata_fixture`, from the same RandomState stream,
with the same XML and image sets, its pixels the arrays that fixture
draws before its JPEG encoding.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def _draw(rng, h: int, w: int) -> tuple:
    """One fixture image from rng's stream: a textured (h, w, 3) u8
    background with 1-3 filled rectangles (drawn by slicing, as
    cv2.rectangle fills them), and their 0-based inclusive boxes."""
    img = (rng.rand(h, w, 3) * 60 + 60).astype(np.uint8)
    boxes = []
    for _ in range(rng.randint(1, 4)):
        bw = rng.randint(min(40, w // 4), min(90, w // 2))
        bh = rng.randint(min(60, h // 4), min(110, h // 2))
        x1 = rng.randint(0, w - bw - 1)
        y1 = rng.randint(0, h - bh - 1)
        img[y1:y1 + bh + 1, x1:x1 + bw + 1] = rng.randint(180, 255, 3)
        boxes.append((x1, y1, x1 + bw, y1 + bh))
    return img, boxes


def _write_xml(adir: str, name: str, boxes, h: int, w: int):
    """The fixture's VOC XML: 'person' boxes, 1-based."""
    objs = '\n'.join(
        f'  <object><name>person</name><bndbox>'
        f'<xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>'
        f'<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax>'
        f'</bndbox></object>'
        for (x1, y1, x2, y2) in boxes)
    xml = (f'<annotation><filename>{name}.jpg</filename>'
           f'<size><width>{w}</width><height>{h}</height>'
           f'<depth>3</depth></size>\n{objs}\n</annotation>')
    with open(osp.join(adir, name + '.xml'), 'w') as f:
        f.write(xml)


def write_rrdata(root: str, n: int, size=(600, 1000), seed: int = 0,
                 image_set: str = 'test', pixel_dir: str | None = None
                 ) -> tuple:
    """Write n images of `size` (h, w) under root (a DATA_DIR), the pixels
    into pixel_dir (default: root/6thfloorData/6thFloorTest/pixels).
    Returns (pixel_dir, gt): gt maps each index to its boxes, 0-based
    inclusive (x1, y1, x2, y2)."""
    rng = np.random.RandomState(seed)
    h, w = size
    base = osp.join(root, '6thfloorData', '6thFloorTest')
    pdir = pixel_dir or osp.join(base, 'pixels')
    adir = osp.join(base, 'Annotations_cvat', '6thFloorTest', 'Annotations')
    sdir = osp.join(base, 'Annotations_cvat', '6thFloorTest', 'ImageSets',
                    'Main')
    for d in (pdir, adir, sdir):
        os.makedirs(d, exist_ok=True)
    names = [f'te{i:03d}' for i in range(n)]
    gt = {}
    for name in names:
        img, gt[name] = _draw(rng, h, w)
        np.save(osp.join(pdir, name + '.npy'), img)
        _write_xml(adir, name, gt[name], h, w)
    with open(osp.join(sdir, image_set + '.txt'), 'w') as f:
        f.write('\n'.join(names) + '\n')
    return pdir, gt


def write_rrdata_fixture(root: str, n_train: int = 4, n_test: int = 3,
                         size=(240, 320), seed: int = 3, sizes=None,
                         pixel_root: str | None = None) -> dict:
    """The DATA_DIR layout of `tests/fixtures.make_rrdata_fixture` under
    root: train images tr000.. then test images te000.., drawn from one
    RandomState(seed) in that order, image sets train, test, trainval (=
    train) and val (= test), the same XML.  sizes: optional (h, w) list
    cycled over each split's images.  The pixels go as `.npy` (the
    fixture draws its rectangles with cv2.rectangle, filled; here they
    are drawn by slicing, the same pixels, and never JPEG-encoded) into
    pixel_root/<imdb name>/ for each of rrData_2021_{train, trainval,
    test, val}: `cache_pixels.default_pixel_dir` when pixel_root is
    ROOT_DIR/build/pixels (the default is root/pixels).  Returns the gt
    boxes of every image, 0-based inclusive (x1, y1, x2, y2)."""
    rng = np.random.RandomState(seed)
    base = osp.join(root, '6thfloorData', '6thFloorTest')
    adir = osp.join(base, 'Annotations_cvat', '6thFloorTest', 'Annotations')
    sdir = osp.join(base, 'Annotations_cvat', '6thFloorTest', 'ImageSets',
                    'Main')
    pixel_root = pixel_root or osp.join(root, 'pixels')
    splits = {'train': [f'tr{i:03d}' for i in range(n_train)],
              'test': [f'te{i:03d}' for i in range(n_test)]}
    splits['trainval'] = splits['train']
    splits['val'] = splits['test']
    pdirs = {s: osp.join(pixel_root, f'rrData_2021_{s}') for s in splits}
    for d in (adir, sdir, *pdirs.values()):
        os.makedirs(d, exist_ok=True)
    gt = {}
    for split, twin in (('train', 'trainval'), ('test', 'val')):
        for k, name in enumerate(splits[split]):
            h, w = sizes[k % len(sizes)] if sizes else size
            img, gt[name] = _draw(rng, h, w)
            for s in (split, twin):
                np.save(osp.join(pdirs[s], name + '.npy'), img)
            _write_xml(adir, name, gt[name], h, w)
    for split, names in splits.items():
        with open(osp.join(sdir, split + '.txt'), 'w') as f:
            f.write('\n'.join(names) + '\n')
    return gt


def gt_detections(imdb_obj, gt: dict) -> list:
    """all_boxes that hold exactly the ground truth, score 1: the
    detections an evaluation must score 1.0 at every threshold."""
    all_boxes = [[np.zeros((0, 5), np.float32)] * imdb_obj.num_images
                 for _ in range(imdb_obj.num_classes)]
    all_boxes[1] = [np.asarray([(*b, 1.0) for b in gt[index]], np.float32)
                    for index in imdb_obj.image_index]
    return all_boxes
