"""Synthetic datasets written with numpy alone: rrData, VOC and COCO
layouts.

The layout and the annotations are those of `tests/fixtures.py`
(`make_rrdata_fixture`): DATA_DIR/6thfloorData/6thFloorTest with VOC XML
'person' boxes and the txt image set; the pixels are `.npy` files (no
JPEG, so no cv2): a textured background with filled rectangles, drawn by
slicing.  `rrData(image_set, config=cfg, pixel_dir=...)` reads it.

`write_rrdata_fixture` writes the noise grid's dataset: the train and
test splits of `make_rrdata_fixture`, from the same RandomState stream,
with the same XML and image sets, its pixels the arrays that fixture
draws before its JPEG encoding.

`write_voc` and `write_coco` write a VOC2007-layout set (XML, image sets)
and a COCO-layout set (an instances json of COCO's 80 categories) over a
list of (h, w) shapes, the same drawn images with random classes, their
pixels `.npy` files named as `pascal_voc` and `coco` read them from a
pixel_dir.
"""

from __future__ import annotations

import json
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


def _write_xml(adir: str, name: str, boxes, h: int, w: int, classes=None):
    """The fixture's VOC XML: boxes 1-based, of class 'person' or of
    classes[k]."""
    classes = classes or ['person'] * len(boxes)
    objs = '\n'.join(
        f'  <object><name>{c}</name><bndbox>'
        f'<xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>'
        f'<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax>'
        f'</bndbox></object>'
        for (x1, y1, x2, y2), c in zip(boxes, classes))
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


# COCO's 80 categories with their (non-contiguous) ids
COCO_CATEGORIES = (
    (1, 'person'), (2, 'bicycle'), (3, 'car'), (4, 'motorcycle'),
    (5, 'airplane'), (6, 'bus'), (7, 'train'), (8, 'truck'), (9, 'boat'),
    (10, 'traffic light'), (11, 'fire hydrant'), (13, 'stop sign'),
    (14, 'parking meter'), (15, 'bench'), (16, 'bird'), (17, 'cat'),
    (18, 'dog'), (19, 'horse'), (20, 'sheep'), (21, 'cow'),
    (22, 'elephant'), (23, 'bear'), (24, 'zebra'), (25, 'giraffe'),
    (27, 'backpack'), (28, 'umbrella'), (31, 'handbag'), (32, 'tie'),
    (33, 'suitcase'), (34, 'frisbee'), (35, 'skis'), (36, 'snowboard'),
    (37, 'sports ball'), (38, 'kite'), (39, 'baseball bat'),
    (40, 'baseball glove'), (41, 'skateboard'), (42, 'surfboard'),
    (43, 'tennis racket'), (44, 'bottle'), (46, 'wine glass'), (47, 'cup'),
    (48, 'fork'), (49, 'knife'), (50, 'spoon'), (51, 'bowl'),
    (52, 'banana'), (53, 'apple'), (54, 'sandwich'), (55, 'orange'),
    (56, 'broccoli'), (57, 'carrot'), (58, 'hot dog'), (59, 'pizza'),
    (60, 'donut'), (61, 'cake'), (62, 'chair'), (63, 'couch'),
    (64, 'potted plant'), (65, 'bed'), (67, 'dining table'),
    (70, 'toilet'), (72, 'tv'), (73, 'laptop'), (74, 'mouse'),
    (75, 'remote'), (76, 'keyboard'), (77, 'cell phone'),
    (78, 'microwave'), (79, 'oven'), (80, 'toaster'), (81, 'sink'),
    (82, 'refrigerator'), (84, 'book'), (85, 'clock'), (86, 'vase'),
    (87, 'scissors'), (88, 'teddy bear'), (89, 'hair drier'),
    (90, 'toothbrush'))


def write_voc(root: str, shapes, year: str = '2007',
              image_set: str = 'test', seed: int = 0,
              pixel_dir: str | None = None) -> tuple:
    """A VOC<year>-layout set under root (a DATA_DIR):
    VOCdevkit<year>/VOC<year>/{Annotations, ImageSets/Main/<image_set>.txt},
    one image per (h, w) of shapes, named 000000, 000001, ..., each with
    1-3 boxes of random VOC classes; the pixels go into pixel_dir
    (default VOCdevkit<year>/VOC<year>/pixels) as <index>.npy.  Returns
    (pixel_dir, gt): gt maps each index to its [(box, class name)],
    boxes 0-based inclusive (x1, y1, x2, y2)."""
    from tpudenoise_torch.data.voc_like import VOC_CLASSES
    rng = np.random.RandomState(seed)
    base = osp.join(root, 'VOCdevkit' + year, 'VOC' + year)
    pdir = pixel_dir or osp.join(base, 'pixels')
    adir = osp.join(base, 'Annotations')
    sdir = osp.join(base, 'ImageSets', 'Main')
    for d in (pdir, adir, sdir):
        os.makedirs(d, exist_ok=True)
    names = [f'{i:06d}' for i in range(len(shapes))]
    gt = {}
    for name, (h, w) in zip(names, shapes):
        img, boxes = _draw(rng, h, w)
        classes = [VOC_CLASSES[k] for k in rng.randint(1, 21, len(boxes))]
        gt[name] = list(zip(boxes, classes))
        np.save(osp.join(pdir, name + '.npy'), img)
        _write_xml(adir, name, boxes, h, w, classes)
    with open(osp.join(sdir, image_set + '.txt'), 'w') as f:
        f.write('\n'.join(names) + '\n')
    return pdir, gt


def write_coco(root: str, shapes, image_set: str = 'minival',
               year: str = '2014', seed: int = 0,
               pixel_dir: str | None = None) -> tuple:
    """A COCO-layout set under root (a DATA_DIR):
    coco/annotations/instances_<image_set><year>.json with COCO's 80
    categories, one image per (h, w) of shapes (ids 1, 2, ...), each
    with 1-3 boxes (xywh, areas) of random categories; the pixels go into
    pixel_dir (default coco/pixels) as COCO_<view>_<id:012d>.npy, the
    reference's file stems (minival and valminusminival in val<year>).
    Returns (pixel_dir, dataset json)."""
    assert len(COCO_CATEGORIES) == 80
    rng = np.random.RandomState(seed)
    base = osp.join(root, 'coco')
    pdir = pixel_dir or osp.join(base, 'pixels')
    adir = osp.join(base, 'annotations')
    for d in (pdir, adir):
        os.makedirs(d, exist_ok=True)
    view = {'minival2014': 'val2014', 'valminusminival2014': 'val2014',
            'test-dev2015': 'test2015'}.get(image_set + year,
                                            image_set + year)
    images, anns = [], []
    for i, (h, w) in enumerate(shapes, start=1):
        img, boxes = _draw(rng, h, w)
        stem = f'COCO_{view}_{i:012d}'
        np.save(osp.join(pdir, stem + '.npy'), img)
        images.append({'id': i, 'width': w, 'height': h,
                       'file_name': stem + '.jpg'})
        cats = rng.randint(0, len(COCO_CATEGORIES), len(boxes))
        for (x1, y1, x2, y2), c in zip(boxes, cats):
            bw, bh = x2 - x1 + 1, y2 - y1 + 1
            anns.append({'id': len(anns) + 1, 'image_id': i,
                         'category_id': COCO_CATEGORIES[c][0],
                         'bbox': [x1, y1, bw, bh], 'area': bw * bh,
                         'iscrowd': 0})
    dataset = {'images': images, 'annotations': anns,
               'categories': [{'id': k, 'name': n}
                              for k, n in COCO_CATEGORIES]}
    with open(osp.join(adir, f'instances_{image_set}{year}.json'),
              'w') as f:
        json.dump(dataset, f)
    return pdir, dataset


# vgg16's conv stages: convs a stage, output channels
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def write_vgg16_checkpoint(prefix: str, seed: int = 0) -> None:
    """A seeded full-width vgg16 in tf-slim's scopes (`vgg_16/convS/
    convS_R/{weights, biases}`, fc6 (7, 7, 512, 4096), fc7 (1, 1, 4096,
    4096)) as a V2 checkpoint at prefix, written by the port's writer:
    a source `cli.convert --net vgg16` reads."""
    from tpudenoise_torch.models.tf_checkpoint import write_checkpoint
    rng = np.random.default_rng(seed)
    scale = np.float32(0.01)
    arrays, cin = {}, 3
    for s, (reps, cout) in enumerate(VGG16_STAGES, start=1):
        for r in range(1, reps + 1):
            pre = f'vgg_16/conv{s}/conv{s}_{r}'
            arrays[pre + '/weights'] = rng.standard_normal(
                (3, 3, cin, cout), np.float32) * scale
            arrays[pre + '/biases'] = rng.standard_normal(cout, np.float32)
            cin = cout
    for name, shape in (('fc6', (7, 7, 512, 4096)),
                        ('fc7', (1, 1, 4096, 4096))):
        arrays[f'vgg_16/{name}/weights'] = rng.standard_normal(
            shape, np.float32) * scale
        arrays[f'vgg_16/{name}/biases'] = rng.standard_normal(4096,
                                                              np.float32)
    write_checkpoint(prefix, arrays)
