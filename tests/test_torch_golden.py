"""The port's f32 vgg16 `forward_test` against the numpy golden of the
whole TEST graph (`tests/numpy_forward.py::vgg16_forward_test_np`: conv
stack, RPN, proposals, crop_and_resize, tail, heads), on the CPU.

Weights: seeded random numpy arrays in the JAX package's layout, drawn as
the JAX golden test draws them (`tests/test_convert.py:323-357`: one
RandomState(5), every variable in the reference's order, N(0, 1) scaled
by 0.01, bbox_pred by 0.001), fed to the port through `from_jax_params`;
no checkpoint and no data.  One 64x96 image of U(-60, 60) (seed 7), two
classes, the default TEST config (RPN 6000 -> 300, NMS 0.7).

Bounds, the JAX test's own (tests/test_convert.py:400-416): the valid
rois are a prefix and as many as the golden's; rois within 2e-3,
cls_prob within 1e-4 (the cls/bbox heads compute in bf16 in both
packages), bbox_pred within 2e-3."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import torch

from tests.numpy_forward import vgg16_forward_test_np
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models.convert import from_jax_params
from tpudenoise_torch.models.faster_rcnn import FasterRCNN

NUM_CLASSES = 2


def _golden_weights(num_classes: int = NUM_CLASSES) -> dict:
    """The JAX golden test's trained-detector weights, as a tree."""
    rng = np.random.RandomState(5)

    def var(name, *shape):
        scale = 0.001 if 'bbox_pred' in name else 0.01
        if shape[0] > 4096:          # fc6: rows in chunks, the same stream
            return np.concatenate([
                (rng.randn(min(2048, shape[0] - i), *shape[1:])
                 .astype(np.float32) * scale)
                for i in range(0, shape[0], 2048)])
        return rng.randn(*shape).astype(np.float32) * scale

    head, cin = {}, 3
    for s, (rep, width) in enumerate(zip((2, 2, 3, 3, 3),
                                         (64, 128, 256, 512, 512)), start=1):
        for r in range(1, rep + 1):
            head[f'conv{s}_{r}'] = {'kernel': var('w', 3, 3, cin, width),
                                    'bias': var('b', width)}
            cin = width
    tail = {}
    for fc, fin in (('fc6', 25088), ('fc7', 4096)):
        tail[fc] = {'kernel': var(fc, fin, 4096), 'bias': var(fc, 4096)}
    rpn = {'rpn_conv': {'kernel': var('rpn', 3, 3, 512, 512),
                        'bias': var('rpn', 512)},
           'rpn_cls_score': {'kernel': var('cls', 1, 1, 512, 18),
                             'bias': var('cls', 18)},
           'rpn_bbox_pred': {'kernel': var('bbox_pred', 1, 1, 512, 36),
                             'bias': var('bbox_pred', 36)}}
    rcnn = {'cls_score': {'kernel': var('cls', 4096, num_classes),
                          'bias': var('cls', num_classes)},
            'bbox_pred': {'kernel': var('bbox_pred', 4096, num_classes * 4),
                          'bias': var('bbox_pred', num_classes * 4)}}
    return {'head': head, 'rpn': rpn,
            'tail': {'tail': tail, 'rcnn': rcnn}}


def held_to_golden(params: dict, tree: dict):
    """The port's f32 vgg16 `forward_test` with the state dict params
    against the numpy golden of the tree, at this file's bounds."""
    cfg = default_config()
    model = FasterRCNN('vgg16', num_classes=NUM_CLASSES, cfg=cfg,
                       dtype=torch.float32)
    assert set(params) == set(model.state_dict())
    img = np.random.RandomState(7).uniform(-60, 60, (64, 96, 3)).astype(
        np.float32)
    out = model.forward_test(params, torch.from_numpy(img)[None],
                             torch.tensor([[64., 96., 1.]]))
    want = vgg16_forward_test_np(tree, img, num_classes=NUM_CLASSES,
                                 rpn_nms_thresh=cfg.TEST.RPN_NMS_THRESH,
                                 pre_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
                                 post_n=cfg.TEST.RPN_POST_NMS_TOP_N)
    mask = out['roi_mask'][0].numpy()
    n = int(mask.sum())
    assert mask[:n].all(), 'valid rois must be a prefix'
    assert n == want['rois'].shape[0] > 0
    np.testing.assert_allclose(out['rois'][0, :n].numpy(), want['rois'],
                               atol=2e-3)
    np.testing.assert_allclose(out['cls_prob'][0, :n].numpy(),
                               want['cls_prob'], atol=1e-4)
    np.testing.assert_allclose(out['bbox_pred'][0, :n].numpy(),
                               want['bbox_pred'], atol=2e-3)


def test_vgg16_forward_test_matches_numpy_golden():
    tree = _golden_weights()
    held_to_golden(from_jax_params(tree), tree)
