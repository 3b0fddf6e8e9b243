"""The port's training data path against the JAX package's on the CPU, on
`tests/fixtures.make_rrdata_fixture` (JPEGs for the JAX side, their
`.npy` pixels from `data/cache_pixels.py` for the port):

* roidb: the gt annotations, flips, sizes and max-overlap stats equal
  (`get_training_roidb`, `filter_roidb`, `combined_roidb`);
* `RoiDataLoader`: at scale 1 every batch bit-equal to the JAX loader's
  (images, im_info, gt boxes and mask, cursor state); at scale 2.5 the
  images within 1 of cv2's u8 INTER_LINEAR (cv2 resizes u8 in fixed
  point, the port in f32 then rounds), all else equal;
* `PrefetchLoader`: the consumed cursor state hands off exactly.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os.path as osp

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture

SIZE = (240, 320)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_data'))
    make_rrdata_fixture(root, n_train=5, n_test=3, size=SIZE)
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.voc_like import rrData
    cfg, jc = default_config(), jcfg()
    for c in (cfg, jc):
        c.DATA_DIR = c.ROOT_DIR = root
    for split in ('train', 'test'):
        d = rrData(split, config=cfg)
        cache_pixels.cache(d, cache_pixels.default_pixel_dir(d.name, cfg))
    return root, cfg, jc


def _jax_roidb(jc, split='train'):
    from tpudenoise.data.roidb import get_training_roidb
    from tpudenoise.data.voc_like import rrData
    d = rrData(split, '2021', config=jc)
    d.set_proposal_method('gt')
    return d, get_training_roidb(d, 'original', jc)


def _port_roidb(cfg, name='rrData_2021_train'):
    from tpudenoise_torch.data.roidb import combined_roidb
    return combined_roidb(name, 'original', cfg)


def test_roidb_matches(env):
    _, cfg, jc = env
    from tpudenoise.data.roidb import filter_roidb as j_filter
    from tpudenoise_torch.data.roidb import filter_roidb
    d, roidb = _port_roidb(cfg)
    assert d.image_path_at(0).endswith('.npy')
    _, want = _jax_roidb(jc)
    assert len(roidb) == len(want) == 10
    for a, b in zip(roidb, want):
        for k in ('boxes', 'gt_classes', 'gt_overlaps', 'seg_areas',
                  'max_overlaps', 'max_classes'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ('flipped', 'width', 'height', 'img_id', 'noise_type'):
            assert a.get(k) == b.get(k), k
        assert osp.splitext(osp.basename(a['image']))[0] == \
            osp.splitext(osp.basename(b['image']))[0]
    assert len(filter_roidb(roidb, cfg)) == len(j_filter(want, jc))


def test_combined_roidb_joins_names(env):
    _, cfg, _ = env
    d, roidb = _port_roidb(cfg, 'rrData_2021_train+rrData_2021_test')
    assert d.name == 'rrData_2021_train+rrData_2021_test'
    assert d.num_classes == 2 and len(roidb) == 16


def test_merge_roidbs():
    from tpudenoise.data.imdb import imdb as jimdb
    from tpudenoise_torch.data.voc_like import VocStyleDataset
    rng = np.random.RandomState(0)

    def entries():
        return [{'boxes': rng.randint(0, 50, (2, 4)).astype(np.uint16),
                 'gt_classes': np.ones(2, np.int32),
                 'gt_overlaps': rng.rand(2, 2).astype(np.float32),
                 'seg_areas': rng.rand(2).astype(np.float32)}
                for _ in range(3)]
    a, b = entries(), entries()
    import copy
    got = VocStyleDataset.merge_roidbs(copy.deepcopy(a), copy.deepcopy(b))
    want = jimdb.merge_roidbs(a, b)
    for x, y in zip(got, want):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _loaders(env, scales, max_size, bucket, batch=2):
    _, cfg, jc = env
    from tpudenoise.data.loader import RoiDataLoader as JLoader
    from tpudenoise_torch.data.loader import RoiDataLoader
    for c in (cfg, jc):
        c.TRAIN.SCALES, c.TRAIN.MAX_SIZE = scales, max_size
    _, roidb = _port_roidb(cfg)
    _, jroidb = _jax_roidb(jc)
    return (RoiDataLoader(roidb, 2, cfg, batch_size=batch, bucket=bucket),
            JLoader(jroidb, 2, jc, batch_size=batch, bucket=bucket))


def test_loader_batches_bit_equal_at_scale_1(env):
    port, jax_loader = _loaders(env, (240,), 320, (256, 320))
    for _ in range(7):           # past an epoch of 10 entries: reshuffles
        got, want = port.forward(), jax_loader.forward()
        assert got['image'].dtype == np.uint8
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        a, b = port.get_state(), jax_loader.get_state()
        np.testing.assert_array_equal(a['perm'], b['perm'])
        assert a['cur'] == b['cur']
        np.testing.assert_array_equal(a['rng'][1], b['rng'][1])


def test_loader_resized_batches_within_1(env):
    port, jax_loader = _loaders(env, (600,), 1000, (608, 800))
    for _ in range(3):
        got, want = port.forward(), jax_loader.forward()
        d = np.abs(got['image'].astype(int) - want['image'])
        assert d.max() <= 1, d.max()
        for k in ('im_info', 'gt_boxes', 'gt_mask'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resize_u8_within_1_of_cv2():
    import cv2

    from tpudenoise_torch.data.loader import resize_u8
    rng = np.random.RandomState(0)
    for h, w, s in ((240, 320, 2.5), (160, 200, 150 / 160),
                    (375, 500, 1.6), (333, 500, 600 / 333)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        im[40:120, 60:200] = (30, 200, 90)
        want = cv2.resize(im, None, None, fx=s, fy=s,
                          interpolation=cv2.INTER_LINEAR)
        got = resize_u8(im, s)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1


def test_prefetch_state_handoff_is_exact(env):
    from tpudenoise_torch.data.prefetch import PrefetchLoader
    port, _ = _loaders(env, (240,), 320, (256, 320))
    ref, _ = _loaders(env, (240,), 320, (256, 320))
    pre = PrefetchLoader(port)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(pre.forward()['image'],
                                          ref.forward()['image'])
        state = pre.get_state()
        after = [ref.forward()['image'] for _ in range(3)]
        pre.set_state(state)
        for want in after:
            np.testing.assert_array_equal(pre.forward()['image'], want)
    finally:
        pre.close()
