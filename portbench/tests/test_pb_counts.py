"""The yardstick's counts: the model FLOPs against a count of the
reference's own convolutions and matmuls (torch's FLOP counter on meta
tensors) for both backbones at 608x1024, and the kernels' least times
against PERF.md's kernel-table bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, spec
from portbench.kernels import (greedy_keep, sap_median_u8,
                               suppression_masks, threefry_draw)
from portbench.reference import detector as R
from portbench.reference.arith import Arith


def _meta_weights(net):
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    return {k: torch.empty(v.shape, device='meta') for k, v in
            FasterRCNN(net, num_classes=2).state_dict().items()}


@pytest.mark.parametrize('net', ['res101', 'vgg16'])
def test_flops_against_the_reference_convs(net):
    conf = spec.config(f'frcnn_{net}_rrdata')
    sd, A = _meta_weights(net), Arith('f32')
    parts = flops.parts(conf)
    with FlopCounterMode(display=False) as fc:
        feat = R.head(sd, net, torch.empty(1, 3, 608, 1024, device='meta'),
                      A)
    assert fc.get_total_flops() == 2 * parts['backbone']
    with FlopCounterMode(display=False) as fc:
        R.rpn(sd, feat, A)
    # R.rpn also sums the box conv's terms once more (the check's scale)
    fh, fw = feat.shape[2:]
    assert fc.get_total_flops() == 2 * (parts['rpn'] + fh * fw * 512 * 36)
    r, size = conf['rpn_post_nms_top_n'], conf['pooling_size']
    crops = torch.empty(r, size, size, feat.shape[1], device='meta')
    with FlopCounterMode(display=False) as fc:
        f = R.tail(sd, net, crops, A)
    assert fc.get_total_flops() == 2 * parts['tail']
    with FlopCounterMode(display=False) as fc:
        A.linear(f, sd['rcnn.cls_score.weight'])
        A.linear(f, sd['rcnn.bbox_pred.weight'])
    assert fc.get_total_flops() == 2 * parts['heads']


def test_flops_hand_count():
    """res101: ~82 GMAC backbone, 11.5 RPN, 220 block4 on 300 crops;
    vgg16: 190, 5.8, 36 (GMAC, 608x1024)."""
    res = flops.parts(spec.config('frcnn_res101_rrdata'))
    vgg = flops.parts(spec.config('frcnn_vgg16_rrdata'))
    # vgg16's first conv at full resolution: 608*1024*3*64*9
    assert vgg['backbone'] > 608 * 1024 * 3 * 64 * 9
    assert round(vgg['tail'] / 1e9, 2) == 35.86     # 300*(25088+4096)*4096
    assert round(res['rpn'] / 1e9, 2) == 11.54      # 38*64*(1024*512*9+3456)
    assert round(res['backbone'] / 1e9, 1) == 81.7
    unit1 = 49 * (1024 * 512 + 512 * 512 * 9 + 512 * 2048 + 1024 * 2048)
    unit = 49 * (2048 * 512 + 512 * 512 * 9 + 512 * 2048)
    assert res['tail'] == 300 * (unit1 + 2 * unit)


def _t(shape, dtype='torch.uint8'):
    return ('tensor', tuple(shape), dtype, None)


def test_kernel1_bound():
    # PERF.md: kernel 1 at (8, 600, 1000, 3) 0.0110 ms (operations)
    args = [_t((8, 600, 1000, 3)), _t((8, 600, 1000, 3)),
            _t((8,), 'torch.int32'), 8, 600, 3000, 0, 1]
    assert round(sap_median_u8.cost(args) * 1e3, 4) == 0.0110


def test_kernel3_bound():
    # PERF.md: kernel 3 at 8 x 6144 0.0338 ms (operations)
    args = [_t((8, 6144, 4), 'torch.float32'),
            _t((8, 192, 6144), 'torch.int32'), 8, 6144, 0.7]
    assert round(suppression_masks.cost(args) * 1e3, 4) == 0.0338


def test_threefry_and_walk_counts():
    # PERF.md: threefry normal 8 x 1.8M 0.0224 ms
    assert round(threefry_draw.cost(
        [None, None, 8, 1800000, 2, 0.0, 1.0, 1.0]) * 1e3, 4) == 0.0224
    # the walk's floor: 10 strips of an 8 x 6144 problem set
    s = greedy_keep.cost([None, None, None, 8, 6144, 300])
    assert s == pytest.approx(4 * 8 * sum(6144 - 32 * k for k in range(10))
                              / 3.35e12)
