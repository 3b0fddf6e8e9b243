"""The port's COCO dataset (`data/coco.py`) and in-repo COCO API
(`data/coco_api.py`) against the JAX package's, on fixtures written in
the test: `tests/test_coco.py`'s hand-written json (non-contiguous
category ids, a crowd region, a box past the image edge) and a
numpy-written set of COCO's 80 categories over six image shapes
(`data/synthetic.write_coco`).  Roidbs, image paths, the results json and
COCOeval `stats` (12 numbers) to 1e-12; `tests/test_coco.py`'s
hand-checked evaluations on the port's API; `cache_pixels --imdb` and
`get_imdb` on the cache."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import json
import os
import os.path as osp
import pickle

import cv2
import numpy as np
import pytest

from tpudenoise_torch.data import synthetic

SHAPES = [(480, 640), (640, 480), (427, 640), (640, 427), (612, 612),
          (375, 500)]


def _write_fixture(root):
    """`tests/test_coco.py`'s annotations (val2014)."""
    ann_dir = osp.join(root, 'coco', 'annotations')
    os.makedirs(ann_dir)
    dataset = {
        'images': [{'id': 1, 'width': 100, 'height': 80},
                   {'id': 2, 'width': 100, 'height': 80}],
        'categories': [{'id': 1, 'name': 'person'},
                       {'id': 3, 'name': 'car'}],
        'annotations': [
            {'id': 10, 'image_id': 1, 'category_id': 1, 'iscrowd': 0,
             'bbox': [10, 10, 20, 30], 'area': 600},
            {'id': 11, 'image_id': 1, 'category_id': 3, 'iscrowd': 0,
             'bbox': [50, 5, 30, 20], 'area': 600},
            {'id': 12, 'image_id': 1, 'category_id': 1, 'iscrowd': 1,
             'bbox': [0, 40, 50, 35], 'area': 1750},
            {'id': 13, 'image_id': 2, 'category_id': 1, 'iscrowd': 0,
             'bbox': [90, 65, 20, 20], 'area': 400}]}
    with open(osp.join(ann_dir, 'instances_val2014.json'), 'w') as f:
        json.dump(dataset, f)


def _configs(root):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = c.ROOT_DIR = root
    return jc, tc


def _pair(root, split):
    from tpudenoise.data.coco import coco as jax_coco
    from tpudenoise_torch.data.coco import coco
    jc, tc = _configs(root)
    return coco(split, '2014', config=tc), jax_coco(split, '2014', config=jc)


def _detections(d, rng, per_image=30):
    """all_boxes from the roidb: jittered ground truth in its class (two
    copies) and clutter of random classes, random scores."""
    all_boxes = [[np.zeros((0, 5), np.float32)] * d.num_images
                 for _ in range(d.num_classes)]
    for i, r in enumerate(d.gt_roidb()):
        rows = {}
        for box, cls in zip(r['boxes'].astype(np.float64), r['gt_classes']):
            for _ in range(2):
                rows.setdefault(int(cls), []).append(
                    (*(box + rng.uniform(-6, 6, 4)), rng.uniform()))
        for _ in range(per_image):
            x, y = rng.uniform(0, 300, 2)
            rows.setdefault(int(rng.randint(1, d.num_classes)), []).append(
                (x, y, x + rng.uniform(5, 200), y + rng.uniform(5, 200),
                 rng.uniform()))
        for c, rr in rows.items():
            all_boxes[c][i] = np.asarray(rr, np.float32)
    return all_boxes


def _stats(out_dir):
    with open(osp.join(out_dir, 'detection_results.pkl'), 'rb') as f:
        return np.asarray(pickle.load(f).stats)


@pytest.mark.parametrize('fixture', ['hand', 'coco80'])
def test_coco_matches_jax(tmp_path, fixture):
    root = str(tmp_path)
    if fixture == 'hand':
        _write_fixture(root)
        split = 'val'
    else:
        synthetic.write_coco(root, SHAPES * 2, seed=4)
        split = 'minival'
    d, j = _pair(root, split)
    assert d.name == j.name and d.classes == j.classes
    assert d.num_classes == (3 if fixture == 'hand' else 81)
    assert d._class_to_coco_cat_id == j._class_to_coco_cat_id
    assert d.image_index == j.image_index
    assert [d.image_path_at(i) for i in range(d.num_images)] == [
        j.image_path_at(i) for i in range(j.num_images)]
    rj = j.gt_roidb()
    os.remove(osp.join(d.cache_path, d.name + '_gt_roidb.pkl'))
    rd = d.gt_roidb()
    for a, b in zip(rd, rj):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    all_boxes = _detections(d, np.random.RandomState(len(fixture)))
    outs = [str(tmp_path / n) for n in ('out_torch', 'out_jax')]
    for ds, out in zip((d, j), outs):
        os.makedirs(out)
        assert ds.evaluate_detections(all_boxes, out) is None
    res = []
    for out in outs:
        with open(osp.join(out, f'detections_{split}2014_results.json')) as f:
            res.append(json.load(f))
    assert res[0] == res[1] and len(res[0]) > 0
    s_d, s_j = _stats(outs[0]), _stats(outs[1])
    assert s_d.shape == (12,) and np.isfinite(s_d).all()
    np.testing.assert_allclose(s_d, s_j, rtol=0, atol=1e-12)
    assert 0 < s_d[0] < 1


def test_roidb_semantics_and_perfect_detections(tmp_path, capsys):
    """`tests/test_coco.py`'s roidb checks and perfect detections (AP =
    AR = 1, the crowd region no miss) on the port."""
    root = str(tmp_path)
    _write_fixture(root)
    d, _ = _pair(root, 'val')
    assert d.classes == ('__background__', 'person', 'car')
    r1, r2 = d.gt_roidb()
    np.testing.assert_array_equal(r1['boxes'][0], [10, 10, 29, 39])
    assert r1['gt_classes'][0] == 1 and r1['gt_classes'][1] == 2
    assert (r1['gt_overlaps'][2] == -1).all()
    np.testing.assert_array_equal(r2['boxes'][0], [90, 65, 99, 79])
    assert d.image_path_at(0).endswith('COCO_val2014_000000000001.jpg')
    cat_to_cls = {1: 1, 3: 2}
    all_boxes = [[np.zeros((0, 5), np.float32)] * 2
                 for _ in range(d.num_classes)]
    for ann in d._COCO.dataset['annotations']:
        if ann['iscrowd']:
            continue
        x, y, w, h = ann['bbox']
        i = ann['image_id'] - 1
        cls = cat_to_cls[ann['category_id']]
        det = np.asarray([[x, y, x + w - 1, y + h - 1, 0.9]], np.float32)
        all_boxes[cls][i] = np.vstack([all_boxes[cls][i], det])
    d.evaluate_detections(all_boxes, str(tmp_path))
    assert 'AP @[.50:.95 | all | 100]' in capsys.readouterr().out
    stats = _stats(str(tmp_path))
    assert abs(stats[0] - 1.0) < 1e-6 and abs(stats[8] - 1.0) < 1e-6


def _one_gt(extra=()):
    from tpudenoise_torch.data.coco_api import COCO
    gt = COCO()
    gt.dataset = {
        'images': [{'id': 1, 'width': 200, 'height': 200}],
        'categories': [{'id': 1, 'name': 'x'}],
        'annotations': [{'id': 1, 'image_id': 1, 'category_id': 1,
                         'iscrowd': 0, 'bbox': [10, 10, 20, 20],
                         'area': 400}, *extra]}
    gt.create_index()
    return gt


def _run(gt, dets):
    from tpudenoise_torch.data.coco_api import COCOeval
    ev = COCOeval(gt, gt.loadRes(dets), 'bbox')
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev.stats


def test_cocoeval_hand_checked_cases():
    """`tests/test_coco.py`: a lower-scored FP keeps AP 1, a higher-scored
    one halves it; per-area-range re-matching; loadRes copies."""
    gt = _one_gt()
    tp = {'image_id': 1, 'category_id': 1, 'bbox': [10, 10, 20, 20],
          'score': 0.9}

    def fp(score):
        return {'image_id': 1, 'category_id': 1, 'bbox': [60, 60, 20, 20],
                'score': score}

    assert abs(_run(gt, [tp, fp(0.1)])[0] - 1.0) < 1e-6
    assert abs(_run(gt, [tp, fp(0.99)])[0] - 0.5) < 0.01
    gt = _one_gt()
    gt.dataset['annotations'] = [
        {'id': 1, 'image_id': 1, 'category_id': 1, 'iscrowd': 0,
         'bbox': [10, 10, 30, 30], 'area': 900},
        {'id': 2, 'image_id': 1, 'category_id': 1, 'iscrowd': 0,
         'bbox': [8, 8, 40, 40], 'area': 1600}]
    gt.create_index()
    stats = _run(gt, [{'image_id': 1, 'category_id': 1,
                       'bbox': [8, 8, 40, 40], 'score': 0.9}])
    assert abs(stats[9] - 0.2) < 1e-6, stats[9]
    dets = [dict(tp)]
    gt.loadRes(dets)
    assert set(dets[0]) == {'image_id', 'category_id', 'bbox', 'score'}


def test_cache_pixels_and_factory(tmp_path):
    from tpudenoise.data.factory import list_imdbs as jax_list_imdbs
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.factory import get_imdb, list_imdbs
    from tpudenoise_torch.utils.image_io import image_hw, read_bgr
    root = str(tmp_path)
    pdir, dataset = synthetic.write_coco(root, SHAPES)
    jc, tc = _configs(root)
    jpeg = get_imdb('coco_2014_minival', tc)
    assert jpeg.image_path_at(0).endswith('.jpg')
    os.makedirs(osp.join(root, 'coco', 'images', 'val2014'))
    for i in range(jpeg.num_images):
        cv2.imwrite(jpeg.image_path_at(i), np.load(osp.join(
            pdir, jpeg.image_stem_at(i) + '.npy')))
    out = cache_pixels.default_pixel_dir('coco_2014_minival', tc)
    assert cache_pixels.main(['--imdb', 'coco_2014_minival', '--data-dir',
                              root, '--out', out]) == 0
    cached = get_imdb('coco_2014_minival', tc)
    for i, im in enumerate(dataset['images']):
        assert cached.image_path_at(i) == osp.join(
            out, f'COCO_val2014_{im["id"]:012d}.npy')
        assert image_hw(cached.image_path_at(i)) == (im['height'],
                                                     im['width'])
        np.testing.assert_array_equal(read_bgr(cached.image_path_at(i)),
                                      cv2.imread(jpeg.image_path_at(i)))
    names = [n for n in list_imdbs() if n.startswith('coco')]
    assert names == [n for n in jax_list_imdbs() if n.startswith('coco')]
    assert 'coco_2015_test-dev' in names and len(names) == 6
