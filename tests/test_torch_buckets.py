"""Noise buckets for datasets of several image shapes: the port's
`derive_noise_buckets`, `_pad_raw_to_bucket` and bucketed
`test_net_batched` against the JAX package's, on the CPU.

The dataset is `tests/test_bucketed_noise.py`'s shape-diverse fixture (10
images in 10 shapes of both orientations, TEST scale 64, MAX_SIZE 96),
read by the JAX package as JPEGs through cv2 and by the port from their
`.npy` cache (`data/cache_pixels.py`), the same pixels.  Chunks of 4 over
two buckets leave a partial chunk in each.  Tolerance as
`tests/test_torch_slice.py`'s: >= 95% of the JAX detections have a port
twin within 0.5 (px and score), the counts per (class, image) within
one; the single-kind string is raster-dependent (periodic follows each
image's valid extent), the mix string draws through the mix scan.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture
from tests.test_torch_slice import match_row

SIZES = [(96, 128), (80, 112), (128, 96), (112, 80), (96, 112),
         (104, 128), (128, 104), (88, 120), (120, 88), (96, 96)]


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    root = str(tmp_path_factory.mktemp('tbuckets'))
    make_rrdata_fixture(root, n_test=10, sizes=SIZES)
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = c.ROOT_DIR = root
        c.EXP_DIR = 'bucketed'
        c.TEST.SCALES = (64,)
        c.TEST.MAX_SIZE = 96
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 32
    return jc, tc


def cached_rrdata(tc):
    """The port's rrData on the `.npy` cache of the fixture's JPEGs."""
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.voc_like import rrData
    jpeg = rrData('test', '2021', config=tc)
    pdir = cache_pixels.default_pixel_dir(jpeg.name, tc)
    cache_pixels.cache(jpeg, pdir)
    return rrData('test', '2021', config=tc, pixel_dir=pdir)


def test_derive_noise_buckets_matches_jax():
    from tpudenoise.eval.harness import \
        derive_noise_buckets as jax_derive_noise_buckets
    from tpudenoise_torch.eval.harness import derive_noise_buckets
    rng = np.random.RandomState(0)
    cases = [[(480, 640)] * 5, SIZES, [(375, 500), (500, 375)],
             [(500, 500), (400, 500)], [(3, 2)]]
    cases += [[tuple(int(v) for v in rng.randint(50, 700, 2))
               for _ in range(rng.randint(1, 30))] for _ in range(20)]
    for shapes in cases:
        assert derive_noise_buckets(shapes) == jax_derive_noise_buckets(
            shapes), shapes
    assert derive_noise_buckets(SIZES) == {'l': (104, 128), 'p': (128, 104)}


def test_pad_raw_to_bucket_matches_jax():
    from tpudenoise.eval.harness import _pad_raw_to_bucket as jax_pad
    from tpudenoise_torch.eval.harness import _pad_raw_to_bucket
    rng = np.random.RandomState(1)
    for (h, w), bucket in (((37, 53), (48, 80)), ((48, 80), (48, 80)),
                           ((20, 80), (48, 80)), ((48, 9), (48, 80))):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = _pad_raw_to_bucket(im, bucket)
        want = jax_pad(im.astype(np.float32), bucket)
        assert got.dtype == np.uint8 and got.shape == (*bucket, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('noise', ['periodic_var100', 'noise_mix_var_low'])
def test_bucketed_test_net_batched_matches_jax(env, noise, monkeypatch):
    """Two buckets, the noise stage on at most two canvas shapes, and the
    detections as the JAX package's."""
    from tpudenoise_torch.eval import harness
    seen = set()
    make = harness.make_pipeline

    def spy(*a, **kw):
        fn = make(*a, **kw)
        inner = fn.masked

        def masked(keys, images, hw):
            seen.add(tuple(images.shape))
            return inner(keys, images, hw)

        fn.masked = masked
        return fn

    monkeypatch.setattr(harness, 'make_pipeline', spy)
    matched, total = match_row(env, noise, monkeypatch, eval_batch=4,
                               bucket=None, port_imdb=cached_rrdata)
    assert seen == {(4, 104, 128, 3), (4, 128, 104, 3)}, seen
    assert total > 0 and matched / total >= 0.95, (matched, total)
