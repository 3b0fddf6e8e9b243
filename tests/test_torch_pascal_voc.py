"""The port's `pascal_voc` (on its `imdb` base) against the JAX package's,
on VOC2007- and VOC2012-layout fixtures written in the test
(`data/synthetic.write_voc`, JPEGs from its pixels by cv2, one object
marked difficult): gt roidbs with and without `use_diff`, image paths,
results files and APs (IoU 0.5, the VOC07 11-point metric for 2007 only)
to 1e-12; flips; `cache_pixels --imdb` and `get_imdb` on the cache."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import os.path as osp

import cv2
import numpy as np
import pytest

from tpudenoise_torch.data import synthetic

SHAPES = [(375, 500), (500, 375), (333, 500), (500, 333), (366, 500),
          (500, 400)]


def _fixture(root, year):
    """The VOC<year> set with JPEGs; image 0 gains a difficult object."""
    pdir, gt = synthetic.write_voc(root, SHAPES, year=year, seed=int(year))
    base = osp.join(root, 'VOCdevkit' + year, 'VOC' + year)
    jdir = osp.join(base, 'JPEGImages')
    os.makedirs(jdir)
    for name in gt:
        cv2.imwrite(osp.join(jdir, name + '.jpg'),
                    np.load(osp.join(pdir, name + '.npy')))
    path = osp.join(base, 'Annotations', '000000.xml')
    with open(path) as f:
        xml = f.read()
    with open(path, 'w') as f:
        f.write(xml.replace('</annotation>', (
            '  <object><name>dog</name><difficult>1</difficult><bndbox>'
            '<xmin>11</xmin><ymin>21</ymin><xmax>60</xmax><ymax>90</ymax>'
            '</bndbox></object>\n</annotation>')))
    return gt


def _configs(root):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = c.ROOT_DIR = root
    return jc, tc


def _detections(gt, names, classes, rng):
    """all_boxes: jittered copies of the ground truth in its class plus
    clutter of random classes."""
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in names]
                 for _ in classes]
    for i, name in enumerate(names):
        rows = {}
        for (x1, y1, x2, y2), cls in gt[name]:
            for _ in range(2):
                j = rng.uniform(-10, 10, 4)
                rows.setdefault(classes.index(cls), []).append(
                    (x1 + j[0], y1 + j[1], x2 + j[2], y2 + j[3],
                     rng.uniform()))
        for _ in range(6):
            x, y = rng.uniform(0, 300, 2)
            rows.setdefault(int(rng.randint(1, len(classes))), []).append(
                (x, y, x + rng.uniform(10, 80), y + rng.uniform(10, 80),
                 rng.uniform()))
        for c, r in rows.items():
            all_boxes[c][i] = np.asarray(r, np.float32)
    return all_boxes


@pytest.mark.parametrize('year', ['2007', '2012'])
def test_pascal_voc_matches_jax(tmp_path, year):
    from tpudenoise.data.voc_like import pascal_voc as jax_pascal_voc
    from tpudenoise_torch.data.voc_like import pascal_voc
    root = str(tmp_path)
    gt = _fixture(root, year)
    jc, tc = _configs(root)
    for use_diff in (False, True):
        d = pascal_voc('test', year, use_diff=use_diff, config=tc)
        j = jax_pascal_voc('test', year, use_diff=use_diff, config=jc)
        assert d.name == j.name and list(d.classes) == list(j.classes)
        assert d.image_index == j.image_index == sorted(gt)
        assert d._use_07_metric() == j._use_07_metric() == (year == '2007')
        assert d._iou_thresholds() == j._iou_thresholds() == [0.5]
        assert [d.image_path_at(i) for i in range(d.num_images)] == [
            j.image_path_at(i) for i in range(j.num_images)]
        rj = j.gt_roidb()
        os.remove(osp.join(d.cache_path, d.name + '_gt_roidb.pkl'))
        rd = d.gt_roidb()
        assert len(rd[0]['boxes']) == len(gt['000000']) + use_diff
        for a, b in zip(rd, rj):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype

    d = pascal_voc('test', year, config=tc)
    j = jax_pascal_voc('test', year, config=jc)
    all_boxes = _detections(gt, d.image_index, list(d.classes),
                            np.random.RandomState(int(year)))
    texts = []
    for ds in (d, j):
        ds.competition_mode(True)
        ds._write_voc_results_file(all_boxes)
        with open(ds._results_template().format('dog')) as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and texts[0]
    aps_d = d.evaluate_detections(all_boxes, str(tmp_path / 'out_torch'))
    aps_j = j.evaluate_detections(all_boxes, str(tmp_path / 'out_jax'))
    assert len(aps_d) == 20 and np.isfinite(aps_d).all()
    assert 0 < np.mean(aps_d) < 1
    np.testing.assert_allclose(aps_d, aps_j, rtol=0, atol=1e-12)


def test_flips_cache_and_factory(tmp_path):
    from tpudenoise.data.voc_like import pascal_voc as jax_pascal_voc
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.factory import get_imdb, list_imdbs
    from tpudenoise_torch.data.voc_like import pascal_voc
    from tpudenoise_torch.utils.image_io import read_bgr
    root = str(tmp_path)
    _fixture(root, '2007')
    jc, tc = _configs(root)
    d = pascal_voc('test', '2007', config=tc)
    j = jax_pascal_voc('test', '2007', config=jc)
    d.append_flipped_images()
    j.append_flipped_images()
    assert d.image_index == j.image_index and d.num_images == 12
    for a, b in zip(d.roidb, j.roidb):
        np.testing.assert_array_equal(a['boxes'], b['boxes'])
        assert a['flipped'] == b['flipped']
    # cache_pixels --imdb writes build/pixels/voc_2007_test, where
    # get_imdb then reads every image
    out = cache_pixels.default_pixel_dir('voc_2007_test', tc)
    assert cache_pixels.main(['--imdb', 'voc_2007_test', '--data-dir', root,
                              '--out', out]) == 0
    cached = get_imdb('voc_2007_test', tc)
    jpeg = get_imdb('voc_2007_test', tc, pixels=False)
    for i in range(cached.num_images):
        assert cached.image_path_at(i) == osp.join(
            out, cached.image_index[i] + '.npy')
        np.testing.assert_array_equal(read_bgr(cached.image_path_at(i)),
                                      cv2.imread(jpeg.image_path_at(i)))
    assert {f'voc_{y}_{s}' for y in ('2007', '2012')
            for s in ('train', 'val', 'trainval', 'test')} <= set(
                list_imdbs())
