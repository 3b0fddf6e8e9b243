"""The port's ResNet Faster R-CNN against the JAX package on the same
weights (carried by `from_jax_params`).

res50 runs in f32 at 64x96 with RPN 128 -> 8, on the JAX init with every
conv3 kernel and every BN statistic replaced by seeded random values (the
seeded init zeroes conv3, which would leave the residual branches out of
the comparison).  Tolerance as for vgg16 (tests/test_torch_detector.py):
the heads compute in bf16 in both packages, so a value that straddles a
bf16 rounding boundary moves a logit by one ulp; cls_prob is held to 1e-4
on at least 99% of its entries and to 1e-3 on all, `roi_mask` exactly, and
each JAX roi must have a port twin within 1e-2 px.  res101 and res152 are
held in keys and shapes against `jax.eval_shape` of the JAX init."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models.backbones import resnet
from tpudenoise_torch.models.convert import from_jax_params, load_npz
from tpudenoise_torch.models.faster_rcnn import FasterRCNN

SIZE = (64, 96)


def _randomize(tree, rng):
    """Seeded random conv3 kernels and BN statistics, in place of the
    init's zeros and identities."""
    out = {}
    for name, p in tree.items():
        if not isinstance(p, dict):
            out[name] = p
        elif name == 'conv3':
            k = p['kernel']
            std = 0.3 / np.sqrt(np.prod(k.shape[:3]))
            out[name] = {'kernel': (rng.randn(*k.shape) * std).astype(
                np.float32)}
        elif 'gamma' in p:
            c = p['gamma'].shape
            out[name] = {
                'gamma': rng.uniform(0.5, 1.5, c).astype(np.float32),
                'beta': (rng.randn(*c) * 0.1).astype(np.float32),
                'mean': (rng.randn(*c) * 0.1).astype(np.float32),
                'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
        else:
            out[name] = _randomize(p, rng)
    return out


def _configs():
    from tpudenoise.core.config import default_config as jcfg
    jc, tc = jcfg(), default_config()
    for c in (jc, tc):
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 8
    return jc, tc


@pytest.fixture(scope='module')
def res50():
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    jc, tc = _configs()
    jm = JRCNN(backbone='res50', num_classes=3, cfg=jc, dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init(jax.random.PRNGKey(0), SIZE))
    jp = _randomize(jp, np.random.RandomState(0))
    tm = FasterRCNN('res50', num_classes=3, cfg=tc, dtype=torch.float32)
    params = from_jax_params(jp)
    return jm, jp, tm, params


@pytest.fixture(scope='module')
def res50_outputs(res50):
    jm, jp, tm, params = res50
    rng = np.random.RandomState(3)
    imgs = (rng.randn(2, *SIZE, 3) * 40).astype(np.float32)
    info = np.asarray([[64, 96, 1.0], [60, 80, 1.0]], np.float32)
    got = tm.forward_test(params, torch.from_numpy(imgs),
                          torch.from_numpy(info))
    want = [jm.forward_test(jp, jnp.asarray(imgs[i]), jnp.asarray(info[i]))
            for i in range(2)]
    return got, want


def test_res50_forward_test_matches(res50_outputs):
    got, want = res50_outputs
    for i, w in enumerate(want):
        diff = np.abs(got['cls_prob'][i].numpy() - np.asarray(w['cls_prob']))
        assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 1e-3, \
            diff.max()
        np.testing.assert_array_equal(got['roi_mask'][i].numpy(),
                                      np.asarray(w['roi_mask']))
        got_r = got['rois'][i].numpy()
        for row in np.asarray(w['rois']):
            assert np.abs(got_r - row).max(1).min() < 1e-2


def test_res50_feat_pooled_matches(res50_outputs):
    """The f32 mean of the (1024-channel) feature map over the bucket."""
    got, want = res50_outputs
    assert got['feat_pooled'].shape == (2, 1024)
    assert got['feat_pooled'].dtype == torch.float32
    for i, w in enumerate(want):
        np.testing.assert_allclose(got['feat_pooled'][i].numpy(),
                                   np.asarray(w['feat_pooled']), atol=1e-4,
                                   rtol=1e-5)


def test_res50_params_load_and_npz_round_trips(res50, tmp_path):
    from tpudenoise.models.convert import save_params_npz
    _, jp, tm, params = res50
    assert set(params) == set(tm.state_dict())
    save_params_npz(jp, str(tmp_path / 'res50.npz'))
    loaded = load_npz(str(tmp_path / 'res50.npz'))
    assert set(loaded) == set(params)
    for k in params:
        assert torch.equal(loaded[k], params[k]), k
    tm.load_state_dict(loaded)
    assert torch.equal(tm.head.block1.unit_1.bn1.var,
                       torch.from_numpy(jp['head']['block1']['unit_1']['bn1']
                                        ['var']))


@pytest.mark.parametrize('backbone,leaves', [('res101', 530),
                                             ('res152', 785)])
def test_state_dict_matches_jax_tree(backbone, leaves):
    """Keys and shapes of the port's state dict against the converted
    shapes of the JAX init (no weights are computed)."""
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    jc, tc = _configs()
    jm = JRCNN(backbone=backbone, num_classes=21, cfg=jc)
    shapes = jax.eval_shape(lambda k: jm.init(k, SIZE),
                            jax.random.PRNGKey(0))
    assert len(jax.tree_util.tree_leaves(shapes)) == leaves
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    got = from_jax_params(zeros)
    want = FasterRCNN(backbone, num_classes=21, cfg=tc).state_dict()
    assert len(got) == leaves
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k


def test_res101_bf16_forward_is_finite():
    m = FasterRCNN(num_classes=21)
    assert m.backbone == 'res101' and m.dtype == torch.bfloat16
    assert not m.pool_then_max
    m.cfg.TEST.RPN_PRE_NMS_TOP_N, m.cfg.TEST.RPN_POST_NMS_TOP_N = 128, 8
    params = m.init(torch.Generator().manual_seed(0))
    assert all(not v.any() for k, v in params.items()
               if k.endswith('conv3.weight'))
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy((rng.randn(2, *SIZE, 3) * 50).astype(np.float32))
    out = m.forward_test(params, imgs, torch.tensor([[64., 96., 1.]] * 2))
    assert out['cls_prob'].shape == (2, 8, 21)
    for k in ('cls_prob', 'bbox_pred', 'feat_pooled'):
        assert out[k].dtype == torch.float32
        assert torch.isfinite(out[k]).all(), k
    assert out['feat_pooled'].shape == (2, 1024)


def test_root_pool_equals_zero_padded_pool():
    """After the ReLU, max_pool2d's -inf padding equals the reference's
    zero pad (1, 1) + 3x3/2 VALID pool, odd and even extents alike."""
    rng = np.random.RandomState(2)
    for h, w in ((32, 48), (33, 47), (5, 6)):
        x = F.relu(torch.from_numpy(rng.randn(2, 4, h, w).astype(
            np.float32)))
        x[0, 0] = 0.0
        want = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        assert torch.equal(F.max_pool2d(x, 3, 2, padding=1), want)


def test_shortcuts_and_strides():
    """The stride sits on the last unit; the last unit of blocks 1 and 2
    subsamples the identity, the first unit of every block projects."""
    head = resnet.ResNetHead(50, torch.float32)
    for name in ('block1', 'block2', 'block3'):
        units = list(getattr(head, name))
        assert hasattr(units[0], 'shortcut')
        assert not any(hasattr(u, 'shortcut') for u in units[1:])
        assert [u.stride for u in units[:-1]] == [1] * (len(units) - 1)
    assert (head.block1[-1].stride, head.block2[-1].stride,
            head.block3[-1].stride) == (2, 2, 1)
    head.reset_parameters(torch.Generator().manual_seed(1))
    out = head(torch.zeros(1, 3, 64, 96).normal_(
        generator=torch.Generator().manual_seed(2)))
    assert out.shape == (1, 1024, 4, 6)


def test_other_backbones_raise():
    """mobile builds, its state dict key for key and shape for shape the
    converted JAX init (full width, 21 classes); res34 and a head of
    unknown layers raise."""
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    jc, tc = _configs()
    shapes = jax.eval_shape(
        lambda k: JRCNN(backbone='mobile', num_classes=21, cfg=jc).init(
            k, SIZE), jax.random.PRNGKey(0))
    got = from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    want = FasterRCNN('mobile', num_classes=21, cfg=tc).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
    with pytest.raises(ValueError, match='unknown'):
        FasterRCNN('res34')
    tree = {'head': {'stem': {}}, 'rpn': {}, 'tail': {}}
    with pytest.raises(ValueError, match='not a vgg16, resnet or mobilenet'):
        from_jax_params(tree)


def test_net_batched_runs_a_res101_model(tmp_path):
    """The port's dataset loop with a seeded bf16 res101, on the fixture
    dataset: every image gets finite detections, and the imdb scores
    them."""
    import os.path as osp
    import pickle

    from tests.fixtures import make_rrdata_fixture
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.data.voc_like import rrData
    from tpudenoise_torch.eval import harness
    make_rrdata_fixture(str(tmp_path), n_test=3, size=(160, 200))
    jc, tc = jcfg(), default_config()
    jc.DATA_DIR = str(tmp_path)
    for c in (jc, tc):
        c.ROOT_DIR = str(tmp_path)
        c.TEST.SCALES = (150,)
        c.TEST.MAX_SIZE = 200
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 16
    d = rrData('test', '2021', config=jc)
    d.competition_mode(True)
    m = FasterRCNN('res101', num_classes=d.num_classes, cfg=tc)
    params = m.init(torch.Generator().manual_seed(0))
    aps = harness.test_net_batched(m, params, d, 'res101',
                                   'sap_median_var0.4', eval_batch=2,
                                   config=tc, bucket=(160, 224))
    assert len(aps) > 0 and np.isfinite(aps).all()
    with open(osp.join(tmp_path, 'output', tc.EXP_DIR, d.name, 'res101',
                       'detections.pkl'), 'rb') as f:
        dets = pickle.load(f)
    for cls in range(1, d.num_classes):
        assert len(dets[cls]) == 3
        for a in dets[cls]:
            assert a.shape[1] == 5 and np.isfinite(a).all()
    assert sum(len(a) for a in dets[1]) > 0
