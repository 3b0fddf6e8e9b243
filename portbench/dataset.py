"""The cell's rrData test split, drawn from the seed and written in the
layout `tpudenoise_torch.data.voc_like.rrData` reads: DATA_DIR/
6thfloorData/6thFloorTest with VOC XML 'person' boxes, the txt image set,
and `.npy` pixels in a directory of their own.

The drawing is that of `tpudenoise_torch.data.synthetic.write_rrdata`
(a textured background, 1-3 filled rectangles drawn by slicing), copied
here so that the benchmark's inputs do not depend on the program."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np


def _draw(rng, h: int, w: int) -> tuple:
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


def _xml(name: str, boxes, h: int, w: int) -> str:
    objs = '\n'.join(
        f'  <object><name>person</name><bndbox>'
        f'<xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>'
        f'<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax>'
        f'</bndbox></object>' for x1, y1, x2, y2 in boxes)
    return (f'<annotation><filename>{name}.jpg</filename>'
            f'<size><width>{w}</width><height>{h}</height>'
            f'<depth>3</depth></size>\n{objs}\n</annotation>')


def rng_for(seed: int) -> np.random.RandomState:
    """A RandomState for any whole-number seed (RandomState itself takes
    only 32 bits)."""
    return np.random.RandomState(
        np.random.SeedSequence(int(seed)).generate_state(4))


def write(root: str, n: int, size, seed: int) -> dict:
    """n images of size (h, w) under root (the DATA_DIR); returns
    {'data_dir', 'pixel_dir', 'names', 'gt'}, gt the 0-based inclusive
    boxes of each image."""
    rng = rng_for(seed)
    h, w = size
    base = osp.join(root, '6thfloorData', '6thFloorTest')
    pdir = osp.join(root, 'pixels')
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
        with open(osp.join(adir, name + '.xml'), 'w') as f:
            f.write(_xml(name, gt[name], h, w))
    with open(osp.join(sdir, 'test.txt'), 'w') as f:
        f.write('\n'.join(names) + '\n')
    return {'data_dir': root, 'pixel_dir': pdir, 'names': names, 'gt': gt}


def frames(ds: dict, idx) -> np.ndarray:
    """The raw (B, H, W, 3) uint8 BGR frames of image indices idx."""
    return np.stack([np.load(osp.join(ds['pixel_dir'], ds['names'][i]
                                      + '.npy')) for i in idx])
