"""The port's TwoNN study (`analysis/twonn.py`) and `compute_id` in the
eval harness against the JAX package on the CPU.

Weights: the port's seeded f32 head with every resnet conv3 kernel and
BN statistic replaced by seeded random values (the seeded init zeroes
conv3, which would leave the probes reading zeros), carried to the JAX
layout by `models.convert.to_jax_flat`.

Bounds, each with its reason (measured values in brackets):
* pairwise_dist: x.xT sums in another order: within 2e-6 of the largest
  distance [1.2e-7];
* estimate_from_dist on the same matrix: n_good equal, d within 1e-5
  relative (XLA's CPU log is not correctly rounded) [1.9e-7];
  duplicates masked in both;
* compute_id: the same numpy subsets; mean and std within 1e-5
  relative [6.3e-7];
* grid pools: f32 cells within 1e-6 relative [6e-8 absolute]; bf16
  cells (the mean in bf16) within one bf16 ulp [equal];
* probe features (vgg16 and res50, pooled over each image's valid
  extent): within 1e-5 of each feature's largest magnitude [2.3e-6];
* test_net_batched(compute_id=True): the logged twonn_id/* and
  twonn_id_err/* within 2e-3 relative of the JAX package's
  make_probe_fn + per_layer_id on the same detector inputs: with 10
  points in thousands of dimensions mu = r2 / r1 lies near 1, so a
  feature's 1e-6 becomes ~1e-4 in log(mu) [6.0e-4].
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise.analysis import twonn as jt
from tpudenoise_torch.analysis import twonn as tt
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models import convert
from tpudenoise_torch.models.backbones.resnet import FrozenBatchNorm
from tpudenoise_torch.models.faster_rcnn import FasterRCNN

SIZE = (48, 64)
# ten images' valid extents, full and padded (the harness test's batch:
# both tests then share the JAX probe function's compile)
HW = np.array([[48, 64], [40, 51], [33, 64], [48, 40], [25, 30]] * 2,
              np.int64)


def _model(backbone: str):
    """(port model, state dict, JAX model, JAX head params, the JAX probe
    function): the seeded f32 detector with its head randomized (conv3
    and BN of the resnets); vgg16's fc6/fc7 stay zero (the probes and
    these tests never read them)."""
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    cfg = default_config()
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 128, 16
    tm = FasterRCNN(backbone, num_classes=2, cfg=cfg, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    parts = (tm.head, tm.rpn, tm.rcnn) + (
        (tm.tail,) if backbone != 'vgg16' else ())
    for m in parts:
        m.reset_parameters(g)
    randomize_head(tm)
    params = tm.state_dict()
    jtree = convert._unflatten(convert.to_jax_flat(
        {k: v for k, v in params.items() if k.startswith('head.')}))
    jm = JRCNN(backbone=backbone, num_classes=2, cfg=jcfg(),
               dtype=jnp.float32)
    return tm, params, jm, jtree, jt.make_probe_fn(jm)


def randomize_head(tm, seed: int = 0):
    """Seeded random conv3 kernels and BN statistics in a resnet head, in
    place of the seeded init's zeros and identities."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, m in tm.head.named_modules():
            if name.endswith('conv3'):
                w = m.weight
                std = 0.3 / np.sqrt(w[0].numel())
                w.copy_(torch.from_numpy(rng.randn(*w.shape) * std))
            elif isinstance(m, FrozenBatchNorm):
                c = m.gamma.shape
                m.gamma.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.beta.copy_(torch.from_numpy(rng.randn(*c) * 0.1))
                m.mean.copy_(torch.from_numpy(rng.randn(*c) * 0.1))
                m.var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))


@pytest.fixture(scope='module')
def vgg16():
    return _model('vgg16')


@pytest.fixture(scope='module')
def res50():
    return _model('res50')


def test_pairwise_dist_matches_jax():
    x = np.random.RandomState(0).randn(60, 12).astype(np.float32)
    want = np.asarray(jt.pairwise_dist(x))
    got = tt.pairwise_dist(torch.from_numpy(x)).numpy()
    assert np.all(np.diag(got) == 0)
    assert np.abs(got - want).max() <= 2e-6 * want.max()


@pytest.mark.parametrize('duplicates', [False, True])
def test_estimate_from_dist_matches_jax(duplicates):
    rng = np.random.RandomState(3)
    x = rng.randn(100, 3).astype(np.float32)
    if duplicates:
        x[10] = x[11]          # r1 == 0 for both: masked
        x[20] = x[21] = x[22]
    dist = np.asarray(jt.pairwise_dist(x))
    wd, wn = jt.estimate_from_dist(dist)
    gd, gn = tt.estimate_from_dist(torch.from_numpy(dist))
    assert int(gn) == int(wn) == (95 if duplicates else 100)
    assert abs(float(gd) - float(wd)) <= 1e-5 * abs(float(wd))
    # the port's own distances mask the same points
    own = tt.estimate_from_dist(tt.pairwise_dist(torch.from_numpy(x)))
    assert int(own[1]) == int(wn)


def test_compute_id_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(120, 3) @ rng.randn(3, 10)).astype(np.float32)
    want = jt.compute_id(x, nres=4, seed=2)
    got = tt.compute_id(x, nres=4, seed=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 2.0 < got[0] < 4.5


def test_grid_pools_match_jax():
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 7, 10, 5).astype(np.float32)
    for shape in ((7, 10), (3, 2)):          # 3x2 < the grid: widened cells
        f = feat[0, :shape[0], :shape[1]]
        np.testing.assert_allclose(
            tt._grid_pool(torch.from_numpy(f), 4).numpy(),
            np.asarray(jt._grid_pool(jnp.asarray(f), 4)), rtol=1e-6,
            atol=1e-7)
    fb = torch.from_numpy(feat[1]).to(torch.bfloat16)
    want = np.asarray(jt._grid_pool(jnp.asarray(fb.float().numpy()).astype(
        jnp.bfloat16), 4))
    got = tt._grid_pool(fb, 4).numpy()
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -8)
    hw = np.array([[7, 10], [5, 3]])
    want = np.asarray(jax.vmap(lambda a, e: jt._grid_pool_dyn(a, e, 4))(
        jnp.asarray(feat), jnp.asarray(hw, jnp.int32)))
    got = tt._grid_pool_dyn(torch.from_numpy(feat), hw, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tt._infer_stride(600, 38) == 16 == jt._infer_stride(600, 38)


@pytest.mark.parametrize('name', ['vgg16', 'res50'])
def test_probe_features_match_jax(name, request):
    """With hw, as the harness pools them (the pools without hw:
    test_grid_pools_match_jax)."""
    tm, params, jm, jtree, jfn = request.getfixturevalue(name)
    imgs = (np.random.RandomState(3).randn(len(HW), *SIZE, 3) * 40
            ).astype(np.float32)
    want = jfn(jtree, jnp.asarray(imgs), jnp.asarray(HW, jnp.int32))
    got = tt.make_probe_fn(tm)(params, torch.from_numpy(imgs), HW)
    assert list(got) == jt.PROBES[name] + ['head'] == list(want)
    for p, w in want.items():
        w = np.asarray(w)
        assert got[p].shape == w.shape and got[p].dtype == torch.float32
        err = np.abs(got[p].numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (p, err)


class _Imdb:
    """An imdb-protocol stub over `.npy` images."""
    name, num_classes = 'twonn_fixture', 2

    def __init__(self, paths):
        self.paths = paths
        self.num_images = len(paths)

    def image_path_at(self, i):
        return self.paths[i]

    def evaluate_detections(self, all_boxes, output_dir):
        return None


class _Recorder:
    active_sinks = False

    def __init__(self):
        self.logged = {}

    def log(self, metrics, step=None):
        self.logged.update(metrics)


def test_net_batched_compute_id_logs_match_jax(res50, tmp_path,
                                               monkeypatch):
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.ops.resize import prep_on_device
    tm, params, jm, jtree, jfn = res50
    cfg = tm.cfg
    cfg.EXP_DIR, cfg.ROOT_DIR = 'twonn', str(tmp_path)
    cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (SIZE[0],), SIZE[1]
    rng = np.random.RandomState(4)
    raw = rng.randint(0, 256, (10, *SIZE, 3)).astype(np.uint8)
    paths = []
    for i, im in enumerate(raw):
        paths.append(str(tmp_path / f'{i}.npy'))
        np.save(paths[-1], im)
    rec = _Recorder()
    monkeypatch.setattr(harness, 'get_metrics_logger', lambda: rec)
    harness.test_net_batched(tm, params, _Imdb(paths), 'w', 'original',
                             eval_batch=4, config=cfg, compute_id=True)
    assert sorted(rec.logged) == sorted(
        [f'twonn_id/{p}' for p in jt.PROBES['res50'] + ['head']]
        + [f'twonn_id_err/{p}' for p in jt.PROBES['res50'] + ['head']])
    # JAX: the probes over the same detector inputs (scale 1: the raw
    # pixels less the means, in the bucket), then per_layer_id
    (geom, bucket), = harness.chunk_levels([SIZE] * 10, cfg.TEST.SCALES,
                                           SIZE[1], None, 'cpu')
    imgs = prep_on_device(torch.from_numpy(raw).float(), geom,
                          cfg.PIXEL_MEANS, bucket).numpy()
    feats = jfn(jtree, jnp.asarray(imgs), jnp.asarray(
        np.tile(np.int32(SIZE), (10, 1))))
    want = jt.per_layer_id({p: np.asarray(v) for p, v in feats.items()},
                           nres=10)
    for p, (mean_id, err_id) in want.items():
        got_mean, got_err = rec.logged[f'twonn_id/{p}'], rec.logged[
            f'twonn_id_err/{p}']
        assert np.isfinite(got_mean) and got_mean > 0
        np.testing.assert_allclose([got_mean, got_err], [mean_id, err_id],
                                   rtol=2e-3, err_msg=p)
