"""The port's eval-only dataset and AP evaluation against the JAX
package's: `voc_eval` and `rrData.evaluate_detections` give the same APs
on identical detections over the fixture (all 10 IoU thresholds, empty
images, no detections at all, tied scores); `read_bgr`/`image_hw` on
cached `.npy` pixels equal cv2/PIL on the JPEG; `test_net_batched` on the
cached pixels equals the same loop on the JPEGs, with the port's own
rrData."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os.path as osp
import pickle
import shutil

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from tests.fixtures import make_rrdata_fixture
from tpudenoise.core.config import default_config as jax_default_config
from tpudenoise.data.voc_like import rrData as jax_rrData
from tpudenoise.eval import voc_eval as jax_voc_eval
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.data import cache_pixels, synthetic
from tpudenoise_torch.data.voc_like import rrData
from tpudenoise_torch.eval import voc_eval
from tpudenoise_torch.utils.image_io import image_hw, read_bgr

N_TEST = 6


@pytest.fixture
def fixture_root(tmp_path):
    gt = make_rrdata_fixture(str(tmp_path), n_test=N_TEST, size=(120, 160),
                             seed=5)
    return str(tmp_path), gt


def _configs(root):
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = root
        c.ROOT_DIR = root
    return jc, tc


def _detections(gt, names, case, rng):
    """all_boxes for the fixture's test set: jittered copies of the
    ground truth plus clutter, with the case's twist."""
    per_image = []
    for k, name in enumerate(names):
        rows = []
        for (x1, y1, x2, y2) in gt[name]:
            for _ in range(3):
                j = rng.uniform(-8, 8, 4)
                rows.append((x1 + j[0], y1 + j[1], x2 + j[2], y2 + j[3],
                             rng.uniform()))
        for _ in range(4):
            x, y = rng.uniform(0, 100, 2)
            rows.append((x, y, x + rng.uniform(5, 50),
                         y + rng.uniform(5, 50), rng.uniform()))
        dets = np.asarray(rows, np.float32)
        if case == 'ties':
            dets[:, 4] = np.round(dets[:, 4] * 4) / 4
        if case == 'empty images' and k % 2:
            dets = np.zeros((0, 5), np.float32)
        if case == 'no detections':
            dets = np.zeros((0, 5), np.float32)
        per_image.append(dets)
    return [[np.zeros((0, 5), np.float32)] * len(names), per_image]


@pytest.mark.parametrize('case', ['random', 'ties', 'empty images',
                                  'no detections'])
def test_evaluate_detections_equals_reference(fixture_root, case):
    root, gt = fixture_root
    jc, tc = _configs(root)
    mine, ref = rrData('test', '2021', config=tc), jax_rrData(
        'test', '2021', config=jc)
    assert (mine.name, mine.num_images, mine.classes) == (
        ref.name, ref.num_images, ref.classes)
    assert mine.image_index == ref.image_index
    all_boxes = _detections(gt, mine.image_index, case,
                            np.random.RandomState(len(case)))
    got = mine.evaluate_detections(all_boxes, osp.join(root, 'out_mine'))
    cache = osp.join(root, '6thfloorData', 'annotations_cache')
    shutil.rmtree(cache)
    want = ref.evaluate_detections(all_boxes, osp.join(root, 'out_ref'))
    assert len(got) == 10
    np.testing.assert_array_equal(got, want)
    if case == 'no detections':
        assert not any(got)
    else:
        assert got[0] > 0


@pytest.mark.parametrize('use_07', [True, False])
def test_voc_eval_equals_reference(fixture_root, use_07):
    """One results file, every threshold, both AP rules: rec, prec and
    ap equal."""
    root, gt = fixture_root
    _, tc = _configs(root)
    d = rrData('test', '2021', config=tc)
    d.competition_mode(True)
    d._write_voc_results_file(_detections(gt, d.image_index, 'ties',
                                          np.random.RandomState(1)))
    det = d._results_template().format('person')
    for thr in d._iou_thresholds():
        args = (det, d._anno_path(), d._image_set_file(), 'person')
        r1, p1, a1 = voc_eval.voc_eval(*args, osp.join(root, 'c1'),
                                       ovthresh=thr, use_07_metric=use_07)
        r2, p2, a2 = jax_voc_eval.voc_eval(*args, osp.join(root, 'c2'),
                                           ovthresh=thr,
                                           use_07_metric=use_07)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(p1, p2)
        assert a1 == a2


def test_ground_truth_scores_one(tmp_path):
    """The numpy-written dataset: its ground truth as detections scores
    1.0 at all 10 thresholds, and its pixels have the written shape."""
    pdir, gt = synthetic.write_rrdata(str(tmp_path), 3, size=(60, 100))
    cfg = default_config()
    cfg.DATA_DIR = str(tmp_path)
    d = rrData('test', config=cfg, pixel_dir=pdir)
    assert d.image_path_at(0) == osp.join(pdir, 'te000.npy')
    assert image_hw(d.image_path_at(2)) == (60, 100)
    aps = d.evaluate_detections(synthetic.gt_detections(d, gt),
                                str(tmp_path / 'out'))
    # 11-point AP sums eleven 1/11 terms: 1.0 to the last bits
    assert len(aps) == 10
    np.testing.assert_allclose(aps, 1.0, rtol=1e-12, atol=0)


def test_cached_pixels_equal_the_jpegs(fixture_root):
    root, _ = fixture_root
    _, tc = _configs(root)
    d = rrData('test', '2021', config=tc)
    out = cache_pixels.default_pixel_dir(d.name, tc)
    assert cache_pixels.main(['--data-dir', root, '--out', out]) == 0
    cached = rrData('test', '2021', config=tc, pixel_dir=out)
    for i in range(d.num_images):
        jpeg = d.image_path_at(i)
        assert jpeg.endswith('.jpg')
        px = read_bgr(cached.image_path_at(i))
        np.testing.assert_array_equal(px, cv2.imread(jpeg))
        np.testing.assert_array_equal(read_bgr(jpeg), px)
        with PIL.Image.open(jpeg) as im:
            assert image_hw(cached.image_path_at(i)) == im.size[::-1]
        assert image_hw(jpeg) == px.shape[:2]


def test_read_bgr_rejects_other_arrays(tmp_path):
    path = str(tmp_path / 'x.npy')
    np.save(path, np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError):
        read_bgr(path)


def test_net_batched_on_cached_pixels_equals_jpegs(fixture_root):
    """The loop with the port's rrData, a seeded vgg16: the same
    detections and APs from the JPEGs (cv2) and from the cached `.npy`
    pixels."""
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    root, _ = fixture_root
    _, tc = _configs(root)
    tc.TEST.SCALES = (120,)
    tc.TEST.MAX_SIZE = 160
    tc.TEST.RPN_PRE_NMS_TOP_N = 128
    tc.TEST.RPN_POST_NMS_TOP_N = 16
    jpeg = rrData('test', '2021', config=tc)
    out = cache_pixels.default_pixel_dir(jpeg.name, tc)
    cache_pixels.cache(jpeg, out)
    npy = rrData('test', '2021', config=tc, pixel_dir=out)
    m = FasterRCNN('vgg16', num_classes=2, cfg=tc, dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    res = {}
    for what, d in (('jpeg', jpeg), ('npy', npy)):
        d.competition_mode(True)
        aps = harness.test_net_batched(m, params, d, what,
                                       'sap_median_var0.4', eval_batch=4,
                                       config=tc, bucket=(128, 160))
        with open(osp.join(root, 'output', tc.EXP_DIR, d.name, what,
                           'detections.pkl'), 'rb') as f:
            res[what] = aps, pickle.load(f)
    (a1, d1), (a2, d2) = res['jpeg'], res['npy']
    assert len(a1) == 10 and np.isfinite(a1).all()
    assert a1 == a2
    assert sum(len(x) for x in d1[1]) > 0
    for x, y in zip(d1[1], d2[1]):
        np.testing.assert_array_equal(x, y)
