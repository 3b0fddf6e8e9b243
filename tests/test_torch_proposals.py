"""The port's proposal methods against the JAX package's on the CPU, on
`tests/fixtures.make_rrdata_fixture` (JPEGs for the JAX side, their `.npy`
pixels from `data/cache_pixels.py` for the port) and a seeded numpy
proposal pickle (jittered gt boxes, their duplicates and random boxes):

* `rpn_roidb` (train: the gt rows merged with the rpn rows; test: the rpn
  rows alone) and `create_roidb_from_box_list`: boxes, gt_classes and
  seg_areas equal, gt_overlaps within 1 ulp (f32) with the same argmax;
* flips, `filter_roidb` and one loader minibatch equal (the train step
  sees only the gt rows: gt_classes != 0);
* `evaluate_recall` for candidate_boxes None and given, areas 'all' and
  'small', and a limit: ar, recalls and gt_overlaps equal.  The JAX
  function writes into `np.asarray` of its jax IoU matrix, which this
  JAX makes read-only (ValueError: assignment destination is
  read-only), so the test hands it a writable copy of the same matrix
  (`writable_jax_overlaps`);
* `set_proposal_method` on 'gt', 'rpn' and an unknown name
  (AttributeError in both).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import pickle

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture

SIZE = (90, 120)
N_TRAIN, N_TEST = 4, 2


def _proposals(rng, gt, n_random=24):
    """Each gt box jittered three times, then random boxes, f32."""
    g = np.asarray(gt, np.float32)
    near = np.repeat(g, 3, 0) + rng.randn(3 * len(g), 4) * 5
    xy = rng.rand(n_random, 2) * (SIZE[1] - 10, SIZE[0] - 10)
    wh = rng.rand(n_random, 2) * 50 + 4
    rand = np.hstack([xy, xy + wh])
    boxes = np.vstack([near, rand])
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, SIZE[1] - 1)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, SIZE[0] - 1)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    return boxes.astype(np.float32)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('proposals')
    gt = make_rrdata_fixture(str(root), n_train=N_TRAIN, n_test=N_TEST,
                             size=SIZE)
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.voc_like import rrData
    cfg, jc = default_config(), jcfg()
    for c in (cfg, jc):
        c.DATA_DIR = c.ROOT_DIR = str(root)
        c.TRAIN.SCALES, c.TRAIN.MAX_SIZE = (SIZE[0],), SIZE[1]
    rng = np.random.RandomState(11)
    files = {}
    for split, prefix, n in (('train', 'tr', N_TRAIN),
                             ('test', 'te', N_TEST)):
        d = rrData(split, config=cfg)
        cache_pixels.cache(d, cache_pixels.default_pixel_dir(d.name, cfg))
        files[split] = str(root / f'rpn_{split}.pkl')
        with open(files[split], 'wb') as f:
            pickle.dump([_proposals(rng, gt[f'{prefix}{i:03d}'])
                         for i in range(n)], f)
    return cfg, jc, files


def _datasets(env, split='train', method='rpn'):
    """(port, jax) rrData of split with `method` set, the port's IoU on
    the CPU."""
    cfg, jc, files = env
    from tpudenoise.data.voc_like import rrData as JrrData
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.voc_like import rrData
    d = rrData(split, config=cfg, pixel_dir=default_pixel_dir(
        f'rrData_2021_{split}', cfg))
    d.device = 'cpu'
    j = JrrData(split, '2021', config=jc)
    for x in (d, j):
        x.config['rpn_file'] = files[split]
        x.set_proposal_method(method)
    return d, j


def _same_rows(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ('boxes', 'gt_classes', 'seg_areas'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        assert a['flipped'] == b['flipped']
        ga, gb = a['gt_overlaps'], b['gt_overlaps']
        assert ga.dtype == gb.dtype == np.float32
        np.testing.assert_array_max_ulp(ga, gb, maxulp=1)
        np.testing.assert_array_equal(ga.argmax(1), gb.argmax(1))


@pytest.mark.parametrize('split', ['train', 'test'])
def test_rpn_roidb_matches_jax(env, split):
    d, j = _datasets(env, split)
    got, want = d.roidb, j.roidb
    _same_rows(got, want)
    n_rpn = [len(b) for b in pickle.load(open(env[2][split], 'rb'))]
    for entry, n in zip(got, n_rpn):
        n_gt = int((entry['gt_classes'] != 0).sum())
        assert len(entry['boxes']) == n + n_gt
        assert (n_gt > 0) == (split == 'train')
        assert (entry['gt_overlaps'][entry['gt_classes'] == 0] > 0).any() \
            == (split == 'train')


def test_create_roidb_from_box_list_matches_jax(env):
    d, j = _datasets(env, 'train', 'gt')
    boxes = pickle.load(open(env[2]['train'], 'rb'))
    _same_rows(d.create_roidb_from_box_list(boxes, d.gt_roidb()),
               j.create_roidb_from_box_list(boxes, j.gt_roidb()))
    _same_rows(d.create_roidb_from_box_list(boxes, None),
               j.create_roidb_from_box_list(boxes, None))


@pytest.mark.parametrize('bg_lo', [0.1, 0.0])
def test_flips_filter_and_loader_match_jax(env, bg_lo):
    cfg, jc, _ = env
    for c in (cfg, jc):
        c.TRAIN.BG_THRESH_LO = bg_lo
    try:
        _flips_filter_and_loader(env, bg_lo)
    finally:
        for c in (cfg, jc):
            c.TRAIN.BG_THRESH_LO = 0.1


def _flips_filter_and_loader(env, bg_lo):
    cfg, jc, _ = env
    from tpudenoise.data.loader import RoiDataLoader as JLoader
    from tpudenoise.data.roidb import filter_roidb as jfilter
    from tpudenoise.data.roidb import get_training_roidb as jtraining
    from tpudenoise_torch.data.loader import RoiDataLoader
    from tpudenoise_torch.data.roidb import filter_roidb, get_training_roidb
    for split in ('train', 'test'):
        d, j = _datasets(env, split)
        got = get_training_roidb(d, 'original', cfg)
        want = jtraining(j, 'original', jc)
        assert len(got) == len(d.image_index) == 2 * len(
            pickle.load(open(env[2][split], 'rb')))
        _same_rows(got, want)
        for a, b in zip(got, want):
            for k in ('max_overlaps', 'max_classes'):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ('width', 'height', 'img_id', 'noise_type'):
                assert a[k] == b[k], k
        got, want = filter_roidb(got, cfg), jfilter(want, jc)
        assert [e['img_id'] for e in got] == [e['img_id'] for e in want]
        assert [e['flipped'] for e in got] == [e['flipped'] for e in want]
        # rpn rows alone (test): no gt overlap, so only bg_lo 0 keeps them
        assert len(got) == (len(d.roidb) if split == 'train' or bg_lo == 0
                            else 0)
        if not got:
            continue
        bucket = (96, 128)
        port = RoiDataLoader(got, 2, cfg, batch_size=2, bucket=bucket)
        jl = JLoader(want, 2, jc, batch_size=2, bucket=bucket)
        a, b = port.forward(), jl.forward()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the batch's boxes are the gt rows only
        assert a['gt_mask'].any() == (split == 'train')


@pytest.fixture
def writable_jax_overlaps(monkeypatch):
    """The JAX bbox_overlaps, its result copied to a writable numpy
    array (the JAX evaluate_recall marks matched rows and columns in
    place)."""
    import tpudenoise.ops.boxes as jboxes
    fn = jboxes.bbox_overlaps
    monkeypatch.setattr(jboxes, 'bbox_overlaps',
                        lambda a, b: np.array(fn(a, b)))


@pytest.mark.parametrize('area,limit,given', [
    ('all', None, False), ('small', None, False), ('all', 10, True),
    ('small', None, True), ('all', None, True)])
def test_evaluate_recall_matches_jax(env, writable_jax_overlaps, area, limit,
                                     given):
    d, j = _datasets(env, 'train')
    boxes = pickle.load(open(env[2]['train'], 'rb')) if given else None
    got = d.evaluate_recall(boxes, area=area, limit=limit)
    want = j.evaluate_recall(boxes, area=area, limit=limit)
    for k in ('recalls', 'thresholds', 'gt_overlaps'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['ar'] == want['ar']
    assert got['gt_overlaps'].size > 0 and np.isfinite(got['ar'])
    if area == 'all' and limit is None:
        assert 0 < got['ar'] <= 1


def test_evaluate_recall_thresholds_and_unknown_area(env,
                                                    writable_jax_overlaps):
    d, j = _datasets(env, 'train')
    t = np.array([0.3, 0.5, 0.7])
    got, want = d.evaluate_recall(thresholds=t), j.evaluate_recall(
        thresholds=t)
    np.testing.assert_array_equal(got['recalls'], want['recalls'])
    for x in (d, j):
        with pytest.raises(AssertionError):
            x.evaluate_recall(area='huge')


def test_set_proposal_method(env):
    d, j = _datasets(env, 'train', 'gt')
    assert d.roidb_handler == d.gt_roidb and j.roidb_handler == j.gt_roidb
    for x in (d, j):
        x.set_proposal_method('rpn')
        assert x.roidb_handler == x.rpn_roidb
        with pytest.raises(AttributeError):
            x.set_proposal_method('selective_search')
    d.config['rpn_file'] = None
    with pytest.raises(AssertionError, match='rpn data not found'):
        d.rpn_roidb()
