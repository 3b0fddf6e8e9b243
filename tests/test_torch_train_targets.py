"""The port's training targets, losses, dropout masks and learning-rate
schedule against the JAX package on the same inputs and keys, on the CPU.

Bounds: the target layers' labels, sampled rois (selected indices), and
weights bit-exact, bbox_targets within 1e-6 absolute; each loss term
within 1e-6 relative; the dropout keep mask equal to flax's bit for bit;
the schedule's rates equal to optax's as f32.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise.ops.anchors import anchor_grid
from tpudenoise.train import losses as jl
from tpudenoise.train.targets import anchor_target_layer as j_anchor
from tpudenoise.train.targets import proposal_target_layer as j_proposal
from tpudenoise_torch.train import losses as tl
from tpudenoise_torch.train.targets import (anchor_target_layer,
                                            proposal_target_layer, randint)

B = 2


def _keys(seed, n=B):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


def _gt(rng, n, g=6, hw=(190, 250)):
    """(B, g, 5) padded gt boxes (class 1 or 2) and their mask."""
    gt = np.zeros((B, g, 5), np.float32)
    gm = np.zeros((B, g), bool)
    for b in range(B):
        for j in range(n[b]):
            w, h = rng.randint(30, 100), rng.randint(30, 100)
            x, y = rng.randint(0, hw[1] - w), rng.randint(0, hw[0] - h)
            gt[b, j] = (x, y, x + w, y + h, 1 + j % 2)
            gm[b, j] = True
    return gt, gm


def _near(rng, gt, gm, n, jitter):
    """n rois per image jittered around that image's gt boxes."""
    out = np.zeros((B, n, 4), np.float32)
    for b in range(B):
        boxes = gt[b, gm[b], :4]
        out[b] = boxes[rng.randint(len(boxes), size=n)] + rng.randn(
            n, 4) * jitter
    return out


@pytest.mark.parametrize('clobber', [False, True])
@pytest.mark.parametrize('rpn_batch', [256, 32])
def test_anchor_targets_match(clobber, rpn_batch):
    rng = np.random.RandomState(rpn_batch + clobber)
    anchors = np.asarray(anchor_grid(12, 16, 16))
    gt, gm = _gt(rng, (3, 5))
    im_hw = np.array([[190., 250.], [170., 230.]], np.float32)
    keys = _keys(7)
    got = anchor_target_layer(keys, torch.from_numpy(anchors),
                              torch.from_numpy(gt), torch.from_numpy(gm),
                              torch.from_numpy(im_hw), rpn_batch=rpn_batch,
                              clobber_positives=clobber)
    for b in range(B):
        want = j_anchor(jnp.asarray(keys[b]), jnp.asarray(anchors),
                        jnp.asarray(gt[b]), jnp.asarray(gm[b]),
                        jnp.asarray(im_hw[b]), rpn_batch=rpn_batch,
                        clobber_positives=clobber)
        np.testing.assert_array_equal(got.labels[b].numpy(),
                                      np.asarray(want.labels))
        if not clobber:
            assert (np.asarray(want.labels) == 1).sum() > 0
        np.testing.assert_allclose(got.bbox_targets[b].numpy(),
                                   np.asarray(want.bbox_targets), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.bbox_inside_weights[b].numpy(),
                                      np.asarray(want.bbox_inside_weights))
        np.testing.assert_array_equal(got.bbox_outside_weights[b].numpy(),
                                      np.asarray(want.bbox_outside_weights))


def _proposal_case(case, rng):
    gt, gm = _gt(rng, (3, 2))
    r = 300
    rois = np.zeros((B, r, 4), np.float32)
    mask = np.zeros((B, r), bool)
    if case == 'mixed':        # fg, bg and invalid rows
        rois[:, :60] = _near(rng, gt, gm, 60, 4.0)
        rois[:, 60:260] = _near(rng, gt, gm, 200, 25.0)
        mask[:, :260] = True
    elif case == 'fg_only':    # fg only: fg slots resampled iid
        rois[:, :20] = _near(rng, gt, gm, 20, 1.0)
        mask[:, :20] = True
    elif case == 'few_bg':     # few bg: bg slots resampled iid
        rois[:, :10] = _near(rng, gt, gm, 10, 1.0)
        rois[:, 10:14] = _near(rng, gt, gm, 4, 1.0) + np.float32(
            [40, 0, 40, 0])
        mask[:, :14] = True
    elif case == 'degenerate':  # neither fg nor bg (no overlap at all)
        rois[:] = (200., 220., 240., 248.)
        mask[:, 5:] = True
    return rois, mask, gt, gm


@pytest.mark.parametrize('use_gt', [False, True])
@pytest.mark.parametrize('case', ['mixed', 'fg_only', 'few_bg',
                                  'degenerate'])
def test_proposal_targets_match(case, use_gt):
    rng = np.random.RandomState(len(case) + 10 * use_gt)
    rois, mask, gt, gm = _proposal_case(case, rng)
    keys = _keys(11)
    got = proposal_target_layer(keys, torch.from_numpy(rois),
                                torch.from_numpy(mask), torch.from_numpy(gt),
                                torch.from_numpy(gm), num_classes=3,
                                batch=64, use_gt=use_gt)
    for b in range(B):
        want = j_proposal(jnp.asarray(keys[b]), jnp.asarray(rois[b]),
                          jnp.asarray(mask[b]), jnp.asarray(gt[b]),
                          jnp.asarray(gm[b]), num_classes=3, batch=64,
                          use_gt=use_gt)
        np.testing.assert_array_equal(got.rois[b].numpy(),
                                      np.asarray(want.rois))
        np.testing.assert_array_equal(got.labels[b].numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.bbox_targets[b].numpy(),
                                   np.asarray(want.bbox_targets), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.bbox_inside_weights[b].numpy(),
                                      np.asarray(want.bbox_inside_weights))
        np.testing.assert_array_equal(got.bbox_outside_weights[b].numpy(),
                                      np.asarray(want.bbox_outside_weights))
    if case == 'degenerate' and not use_gt:
        assert (got.labels == 0).all()
    assert not got.rois.requires_grad


def test_proposal_rois_are_detached():
    rng = np.random.RandomState(1)
    rois, mask, gt, gm = _proposal_case('mixed', rng)
    src = torch.from_numpy(rois).requires_grad_(True)
    out = proposal_target_layer(_keys(2), src, torch.from_numpy(mask),
                                torch.from_numpy(gt), torch.from_numpy(gm),
                                num_classes=3, batch=32)
    assert out.rois.grad_fn is None and not out.rois.requires_grad


@pytest.mark.parametrize('maxval', [[1, 7], [1000, 2**31 - 1]])
def test_randint_with_device_bound_matches_jax(maxval):
    keys = _keys(5)
    got = randint(keys, 50, torch.tensor(maxval)).numpy()
    for b in range(B):
        want = jax.random.randint(jnp.asarray(keys[b]), (50,), 0,
                                  jnp.int32(maxval[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


def test_losses_match():
    rng = np.random.RandomState(0)
    k, s, c = 300, 16, 3
    rpn_logits = rng.randn(B, k, 2).astype(np.float32) * 3
    rpn_labels = rng.randint(-1, 2, (B, k)).astype(np.float32)
    rpn_pred = rng.randn(B, k, 4).astype(np.float32)
    rpn_tgt = rng.randn(B, k, 4).astype(np.float32)
    rpn_in = (rpn_labels == 1)[..., None].repeat(4, -1).astype(np.float32)
    rpn_out = (rpn_labels >= 0)[..., None].repeat(4, -1).astype(
        np.float32) / 50
    cls = rng.randn(B, s, c).astype(np.float32) * 2
    labels = rng.randint(0, c, (B, s)).astype(np.int32)
    pred = rng.randn(B, s, 4 * c).astype(np.float32) * 0.5
    tgt = rng.randn(B, s, 4 * c).astype(np.float32) * 0.5
    iw = (rng.rand(B, s, 4 * c) < 0.3).astype(np.float32)
    args = [rpn_logits, rpn_labels, rpn_pred, rpn_tgt, rpn_in, rpn_out, cls,
            labels, pred, tgt, iw, iw]
    got = tl.detection_losses(*map(torch.from_numpy, args))
    for b in range(B):
        want = jax.jit(jl.detection_losses)(*[jnp.asarray(a[b])
                                              for a in args])
        for name, v in want.items():
            np.testing.assert_allclose(got[name][b].item(), float(v),
                                       rtol=1e-6, err_msg=name)


def test_dropout_mask_equals_flax():
    """VGG16Tail's two dropouts against flax's inside the JAX tail, run as
    the JAX Faster R-CNN runs it (`_TailWithHeads`, rngs={'dropout':
    k_do}), fc6 and fc7 set to output ones: each dropout's captured
    output is its keep mask times 2."""
    from tpudenoise.models.backbones.vgg import VGG16Tail as JTail
    from tpudenoise.models.faster_rcnn import _TailWithHeads
    from tpudenoise_torch.models.backbones import vgg

    r = 6
    jmod = _TailWithHeads(JTail(dtype=jnp.float32), 2, True)
    x = jnp.ones((r, 7, 7, 512), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), x)['params'])
    for fc in ('fc6', 'fc7'):
        p = params['tail'][fc]
        params['tail'][fc] = {'kernel': np.zeros_like(p['kernel']),
                              'bias': np.ones_like(p['bias'])}
    keys = _keys(21)
    for b in range(B):
        _, inter = jmod.apply({'params': params}, x, train=True,
                              rngs={'dropout': jnp.asarray(keys[b])},
                              capture_intermediates=True,
                              mutable=['intermediates'])
        for name in ('Dropout_0', 'Dropout_1'):
            want = np.asarray(
                inter['intermediates']['tail'][name]['__call__'][0])
            got = vgg.dropout(torch.ones(B * r, 4096), keys,
                              name)[b * r:(b + 1) * r].numpy()
            assert set(np.unique(want)) == {0.0, 2.0}
            np.testing.assert_array_equal(got, want)


def test_schedule_matches_optax():
    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.train.train_step import lr_schedule as j_sched
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.train.train_step import lr_schedule

    for warmup in (0, 7):
        for steps in ([30], [10, 30]):
            cfg, jc = default_config(), jcfg()
            for c in (cfg, jc):
                c.TRAIN.STEPSIZE = steps
                c.TRAIN.WARMUP_ITERS = warmup
                c.TRAIN.LEARNING_RATE = 0.001
            got, want = lr_schedule(cfg), j_sched(jc)
            for count in sorted({s + d for s in steps for d in (-1, 0, 1)}
                                | {0, 3, 6}):
                w = np.float32(want(jnp.int32(count)))
                assert np.float32(got(count)) == w, (warmup, steps, count)
