"""A synthetic rrData-layout dataset written with numpy alone.

The layout and the annotations are those of `tests/fixtures.py`
(`make_rrdata_fixture`): DATA_DIR/6thfloorData/6thFloorTest with VOC XML
'person' boxes and the txt image set; the pixels are `.npy` files (no
JPEG, so no cv2): a textured background with filled rectangles, drawn by
slicing.  `rrData(image_set, config=cfg, pixel_dir=...)` reads it.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


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
        img = (rng.rand(h, w, 3) * 60 + 60).astype(np.uint8)
        boxes = []
        for _ in range(rng.randint(1, 4)):
            bw = rng.randint(min(40, w // 4), min(90, w // 2))
            bh = rng.randint(min(60, h // 4), min(110, h // 2))
            x1 = rng.randint(0, w - bw - 1)
            y1 = rng.randint(0, h - bh - 1)
            img[y1:y1 + bh + 1, x1:x1 + bw + 1] = rng.randint(180, 255, 3)
            boxes.append((x1, y1, x1 + bw, y1 + bh))
        np.save(osp.join(pdir, name + '.npy'), img)
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
        gt[name] = boxes
    with open(osp.join(sdir, image_set + '.txt'), 'w') as f:
        f.write('\n'.join(names) + '\n')
    return pdir, gt


def gt_detections(imdb_obj, gt: dict) -> list:
    """all_boxes that hold exactly the ground truth, score 1: the
    detections an evaluation must score 1.0 at every threshold."""
    all_boxes = [[np.zeros((0, 5), np.float32)] * imdb_obj.num_images
                 for _ in range(imdb_obj.num_classes)]
    all_boxes[1] = [np.asarray([(*b, 1.0) for b in gt[index]], np.float32)
                    for index in imdb_obj.image_index]
    return all_boxes
