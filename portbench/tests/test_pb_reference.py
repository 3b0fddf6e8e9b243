"""The plain reference against the port on the CPU at a small size: the
frozen noise copies bit for bit on the quick grid's strings, the prep,
the RPN, the proposal layer, the heads and the detections."""

import numpy as np
import pytest
import torch

from portbench import check, weights
from portbench.reference import detector as R
from portbench.reference import postprocess as RP
from portbench.reference.arith import Arith
from portbench.reference.noise import pipeline as RN
from portbench.reference.noise import prng as RK

QUICK = ['original', 'gaussian_var0.1', 'gaussian_gaus_blur_var0.1',
         'sap_median_var0.4', 'speckle_bilateral_var1.0', 'quant_var7',
         'periodic_var100', 'noise_mix_var_medium', 'noise_mix_var_all']


@pytest.mark.parametrize('noise', QUICK)
def test_noise_copies_equal_the_port(noise):
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.pipeline import make_pipeline
    raw = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3, 24, 40, 3)).astype(np.uint8))
    keys = prng.fold_in(prng.PRNGKey(2**31 + 77), np.arange(3))
    assert np.array_equal(keys, RK.fold_in(RK.PRNGKey(2**31 + 77),
                                           np.arange(3)))
    want = make_pipeline(noise, mode='TEST').keyed(keys, raw)
    got = RN.make_pipeline(noise, mode='TEST').keyed(keys, raw)
    assert torch.equal(got, want)


def _conf(net):
    from portbench import spec
    c = spec.config(f'frcnn_{net}_rrdata')
    c.update(test_scales=[64], test_max_size=96, bucket=[64, 96],
             rpn_pre_nms_top_n=600, rpn_post_nms_top_n=30)
    return c


def _port(net, conf):
    from portbench.harness import program_cfg
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    C = program_cfg(conf, '/nonexistent', '/nonexistent')
    model = FasterRCNN(net, num_classes=2, cfg=C, dtype=torch.float32)
    sd = weights.make(weights.layout(model.state_dict()), 5, 'cpu')
    model.load_state_dict(sd)
    return model, sd


@pytest.mark.parametrize('scale', [(64, 96), (48, 72)])
def test_prep(scale):
    from tpudenoise_torch.ops.resize import prep_on_device
    from tpudenoise_torch.utils.blob import rescale_geometry
    frames = torch.rand(2, 64, 96, 3) * 255
    means = [102.9801, 115.9465, 122.7717]
    got, info = R.prep(frames, means, scale[0], scale[1], (64, 96),
                       Arith('f32'))
    s, oh, ow = rescale_geometry(64, 96, *scale)
    geom = torch.tensor([[64, 96, oh, ow, s]] * 2, dtype=torch.float32)
    want = prep_on_device(frames, geom, means, (64, 96))
    assert torch.allclose(got, want, atol=1e-3)
    assert torch.allclose(info, geom[:, 2:])


@pytest.mark.parametrize('net', ['res101', 'vgg16'])
def test_detector_and_detections(net):
    from tpudenoise_torch.eval.harness import (limit_per_image,
                                               postprocess_detections)
    from tpudenoise_torch.ops.proposal import proposal_layer
    conf = _conf(net)
    model, sd = _port(net, conf)
    A = Arith('f32')
    torch.manual_seed(0)
    imgs = torch.randn(2, 64, 96, 3) * 50
    info = torch.tensor([[64.0, 96.0, 1.0], [60.0, 90.0, 1.0]])
    with torch.no_grad():
        feat_p, _, scores_p, deltas_p, anchors = model._rpn(imgs)
        feat = R.head(sd, net, imgs.permute(0, 3, 1, 2), A)
        scores, deltas, fh, fw, _ = R.rpn(sd, feat, A)
        assert check.rel_err(feat_p.float(), feat) < 1e-4
        assert check.rel_err(scores_p, scores) < 1e-4
        assert check.rel_err(deltas_p, deltas) < 1e-4
        # the proposal layer on the port's own RPN outputs: the same rois
        rois_p, _, mask_p = proposal_layer(
            scores_p, deltas_p, anchors, info[:, :2], 0.7, 600, 30)
        rois, mask = R.proposals(scores_p, deltas_p, fh, fw, info, conf, A)
        assert check.box_diff(rois_p, mask_p, rois, mask) == (
            0, int(mask.sum()))
        out = model.forward_test(model.state_dict(), imgs, info)
        score, delta, _ = R.heads(sd, net, feat, out['rois'], 2, conf, A)
        sel = out['roi_mask']
        # the port's class heads compute in bf16 even in an f32 model
        assert check.rel_err(out['cls_score'][sel], score[sel]) < 2e-2
        assert check.rel_err(out['bbox_pred'][sel], delta[sel]) < 2e-2
        bx, sc, mk = postprocess_detections(
            out['rois'], out['roi_mask'], out['cls_prob'], out['bbox_pred'],
            info, 2, 0.3, 0.0, 100)
        want = RP.detections(out['rois'], out['roi_mask'], out['cls_prob'],
                             out['bbox_pred'], info, conf, A)
    for i in range(2):
        m = limit_per_image(bx[i].numpy(), sc[i].numpy(), mk[i].numpy(),
                            100)
        got = [np.hstack([bx[i, 0][m[0]].numpy(),
                          sc[i, 0][m[0]].numpy()[:, None]])]
        assert len(got[0]) > 0
        assert check.det_diff(got, want[i]) == (0, 2 * len(got[0]))


def test_control_arithmetic_is_lower():
    A = Arith('control')
    x = torch.randn(64, 64)
    assert 1e-3 < check.rel_err(A.linear(x, x), x @ x.T) < 0.2
    assert 0 < check.rel_err(A.resize_operand(x), x) < 1e-3
    assert 1e-4 < check.rel_err(A.decode(x), x) < 1e-2
    assert torch.equal(Arith('f32').decode(x), x)
