"""The port's detection ops and vgg16 Faster R-CNN against the JAX package
on the same inputs and weights (carried by `from_jax_params`), in f32.

Tolerances: the ops are the same f32 formulas, so 1e-4 absolute covers
summation-order differences of the matmul forms.  The detector runs 15
convs and two 4096-wide dense layers whose sums torch and XLA order
differently.  The reference computes its cls/bbox heads in bf16 even in
an f32 model (the port keeps that), so an fc7 value that straddles a bf16
rounding boundary moves a logit by one bf16 ulp: cls_prob is held to
1e-4 on at least 99% of its entries and to 1e-3 on all.  Each JAX roi
must have a port twin within 1e-2 px (a marginal NMS keep may swap
order)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise_torch.ops import boxes as tboxes
from tpudenoise_torch.ops.anchors import anchor_grid, generate_anchors
from tpudenoise_torch.ops.resize import prep_on_device, resize_weights
from tpudenoise_torch.ops.roi_align import (crop_and_resize,
                                            max_pool_2x2_same,
                                            roi_boxes_to_normalized)

ATOL = 1e-4


def test_anchors_equal():
    from tpudenoise.ops import anchors as ja
    np.testing.assert_array_equal(generate_anchors(), ja.generate_anchors())
    for hw in ((5, 7), (38, 63)):
        np.testing.assert_array_equal(anchor_grid(*hw).numpy(),
                                      np.asarray(ja.anchor_grid(*hw)))


def test_boxes_match():
    from tpudenoise.ops import boxes as jb
    rng = np.random.RandomState(0)
    b = rng.uniform(0, 300, (2, 50, 4)).astype(np.float32)
    b[..., 2:] += b[..., :2]
    d = (rng.randn(2, 50, 12) * 0.3).astype(np.float32)
    got = tboxes.bbox_transform_inv(torch.from_numpy(b), torch.from_numpy(d))
    want = np.asarray(jb.bbox_transform_inv(jnp.asarray(b), jnp.asarray(d)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-6)
    hw = (torch.tensor([200., 180.]), torch.tensor([240., 300.]))
    for tf, jf in ((tboxes.clip_boxes, jb.clip_boxes),
                   (tboxes.clip_boxes_lower_only, jb.clip_boxes_lower_only)):
        got = tf(torch.from_numpy(want), hw).numpy()
        for i in range(2):
            np.testing.assert_array_equal(
                got[i], np.asarray(jf(jnp.asarray(want[i]),
                                      (hw[0][i].item(), hw[1][i].item()))))


@pytest.mark.parametrize('geom', [(40, 56, 40, 56, 1.0),
                                  (37, 53, 56, 80, 1.5),
                                  (60, 90, 40, 60, 2 / 3)])
def test_prep_on_device_matches(geom):
    from tpudenoise.ops.resize import prep_on_device as j_prep
    from tpudenoise.ops.resize import resize_weights as j_weights
    h0, w0, oh, ow, s = geom
    bucket = (64, 96)
    np.testing.assert_allclose(
        resize_weights(64, 60, oh, h0, s).numpy(),
        np.asarray(j_weights(64, 60, oh, h0, s)), atol=1e-6)
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (2, 60, 90, 3)).astype(np.float32)
    means = np.array([[[102.9801, 115.9465, 122.7717]]])
    g = np.asarray([geom, geom], np.float32)
    got = prep_on_device(torch.from_numpy(img), torch.from_numpy(g), means,
                         bucket).numpy()
    for i in range(2):
        want = np.asarray(j_prep(jnp.asarray(img[i]), h0, w0, oh, ow, s,
                                 means.astype(np.float32), bucket))
        np.testing.assert_allclose(got[i], want, atol=ATOL, rtol=0)


def test_crop_and_resize_and_pool_match():
    from tpudenoise.ops import roi_align as jr
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 9, 13, 8).astype(np.float32)
    rois = rng.uniform(0, 200, (2, 20, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(0, 80, (2, 20, 2))
    norm = roi_boxes_to_normalized(torch.from_numpy(rois), (9, 13), 16)
    got = max_pool_2x2_same(crop_and_resize(torch.from_numpy(feat), norm, 14))
    for i in range(2):
        jn = jr.roi_boxes_to_normalized(jnp.asarray(rois[i]), (9, 13), 16)
        np.testing.assert_allclose(norm[i].numpy(), np.asarray(jn), atol=1e-7)
        want = jr.max_pool_2x2_same(jr.crop_and_resize(jnp.asarray(feat[i]),
                                                       jn, 14))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    odd = rng.randn(3, 5, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(
        max_pool_2x2_same(torch.from_numpy(odd)).numpy(),
        np.asarray(jr.max_pool_2x2_same(jnp.asarray(odd))))


@pytest.fixture(scope='module')
def detectors():
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.models.convert import from_jax_params
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    jc, tc = jcfg(), default_config()
    for c in (jc, tc):
        c.TEST.RPN_PRE_NMS_TOP_N = 256
        c.TEST.RPN_POST_NMS_TOP_N = 64
    jm = JRCNN(backbone='vgg16', num_classes=3, cfg=jc, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0), image_shape=(160, 224))
    tm = FasterRCNN('vgg16', num_classes=3, cfg=tc, dtype=torch.float32)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    assert set(params) == set(tm.state_dict())
    return jm, jp, tm, params


def test_vgg16_forward_test_matches(detectors):
    jm, jp, tm, params = detectors
    rng = np.random.RandomState(3)
    imgs = (rng.randn(2, 160, 224, 3) * 40).astype(np.float32)
    info = np.asarray([[160, 224, 1.0], [150, 200, 1.0]], np.float32)
    out = tm.forward_test(params, torch.from_numpy(imgs),
                          torch.from_numpy(info))
    for i in range(2):
        want = jm.forward_test(jp, jnp.asarray(imgs[i]), jnp.asarray(info[i]))
        diff = np.abs(out['cls_prob'][i].numpy()
                      - np.asarray(want['cls_prob']))
        assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 1e-3, \
            diff.max()
        np.testing.assert_array_equal(out['roi_mask'][i].numpy(),
                                      np.asarray(want['roi_mask']))
        got_r = out['rois'][i].numpy()
        for row in np.asarray(want['rois']):
            assert np.abs(got_r - row).max(1).min() < 1e-2


def test_npz_layout_loads(detectors, tmp_path):
    from tpudenoise.models.convert import save_params_npz
    from tpudenoise_torch.models.convert import load_npz
    _, jp, _, params = detectors
    save_params_npz(jp, str(tmp_path / 'vgg16.npz'))
    loaded = load_npz(str(tmp_path / 'vgg16.npz'))
    assert set(loaded) == set(params)
    for k in params:
        assert torch.equal(loaded[k], params[k]), k


def test_bf16_default_runs_and_other_backbones_raise():
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    m = FasterRCNN('vgg16', num_classes=3)
    assert m.dtype == torch.bfloat16
    params = m.init(torch.Generator().manual_seed(0))
    m.cfg.TEST.RPN_PRE_NMS_TOP_N, m.cfg.TEST.RPN_POST_NMS_TOP_N = 128, 16
    out = m.forward_test(params, torch.zeros(1, 64, 96, 3),
                         torch.tensor([[64., 96., 1.]]))
    assert out['cls_prob'].dtype == torch.float32
    assert torch.isfinite(out['cls_prob']).all()
    # mobile in bf16 (depth 0.25, the seeded init with its BN statistics
    # randomized) against the JAX package's bf16 forward on the same
    # weights: the feature means within one bf16 ulp (measured: equal),
    # cls_prob within 1e-4 (its heads are bf16 in both), the same
    # roi_mask and rois within 1e-2 px
    from tests.test_torch_resnet import _randomize
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.models import convert
    jc, tc = jcfg(), default_config()
    for c in (jc, tc):
        c.MOBILENET.DEPTH_MULTIPLIER = 0.25
        c.TEST.RPN_PRE_NMS_TOP_N, c.TEST.RPN_POST_NMS_TOP_N = 128, 16
    m = FasterRCNN('mobile', num_classes=3, cfg=tc)
    assert m.dtype == torch.bfloat16
    jp = _randomize(convert._unflatten(convert.to_jax_flat(m.init(
        torch.Generator().manual_seed(0)))), np.random.RandomState(0))
    jm = JRCNN(backbone='mobile', num_classes=3, cfg=jc)
    img = (np.random.RandomState(3).randn(1, 64, 96, 3) * 40).astype(
        np.float32)
    got = m.forward_test(convert.from_jax_params(jp), torch.from_numpy(img),
                         torch.tensor([[64., 96., 1.]]))
    want = jm.forward_test(jp, jnp.asarray(img[0]),
                           jnp.asarray([64., 96., 1.]))
    wf = np.asarray(want['feat_pooled'])
    assert np.all(np.abs(got['feat_pooled'][0].numpy() - wf)
                  <= np.abs(wf) * 2.0 ** -8)
    assert np.abs(got['cls_prob'][0].numpy()
                  - np.asarray(want['cls_prob'])).max() <= 1e-4
    np.testing.assert_array_equal(got['roi_mask'][0].numpy(),
                                  np.asarray(want['roi_mask']))
    for row in np.asarray(want['rois']):
        assert np.abs(got['rois'][0].numpy() - row).max(1).min() < 1e-2


def test_vgg16_feat_pooled_matches(detectors):
    """The f32 mean of the feature map over the padded bucket."""
    jm, jp, tm, params = detectors
    rng = np.random.RandomState(4)
    imgs = (rng.randn(2, 160, 224, 3) * 40).astype(np.float32)
    info = np.asarray([[160, 224, 1.0], [120, 200, 1.0]], np.float32)
    out = tm.forward_test(params, torch.from_numpy(imgs),
                          torch.from_numpy(info))
    assert out['feat_pooled'].shape == (2, 512)
    for i in range(2):
        want = jm.forward_test(jp, jnp.asarray(imgs[i]), jnp.asarray(info[i]))
        np.testing.assert_allclose(out['feat_pooled'][i].numpy(),
                                   np.asarray(want['feat_pooled']),
                                   atol=1e-4, rtol=1e-5)
