"""The weights the cells run: every tensor of the detector's state dict
drawn, none at zero (each resnet conv3 included, which the program's
own seeded init zeroes), the same for the same seed."""

import pytest
import torch

from portbench import weights


def _layout(net):
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    return weights.layout(FasterRCNN(net, num_classes=2).state_dict())


@pytest.mark.parametrize('net', ['res101', 'vgg16'])
def test_no_parameter_at_zero(net):
    spec = _layout(net)
    w = weights.make(spec, 2**31 + 12345, 'cpu')
    assert [k for k, _ in spec] == list(w)
    zero = [k for k, v in w.items() if (v == 0).any()]
    assert not zero
    if net == 'res101':
        conv3 = [k for k in w if k.endswith('conv3.weight')]
        assert len(conv3) == 33
        assert all(w[k].abs().mean() > 1e-3 for k in conv3)


def test_same_seed_same_weights():
    spec = [('head.conv1.weight', (64, 3, 7, 7)),
            ('head.conv1_bn.gamma', (64,)), ('rpn.rpn_conv.bias', (512,))]
    a, b = weights.make(spec, 7, 'cpu'), weights.make(spec, 7, 'cpu')
    c = weights.make(spec, 8, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['head.conv1.weight'], c['head.conv1.weight'])


def test_bn_statistics_in_range():
    spec = [('x.bn1.gamma', (256,)), ('x.bn3.gamma', (256,)),
            ('x.bn1.var', (256,))]
    w = weights.make(spec, 3, 'cpu')
    # the ranges of weights.py, times the seed's jitter in [0.8, 1.2]
    assert 0.4 <= w['x.bn1.gamma'].min() and w['x.bn1.gamma'].max() < 1.2
    assert 0.08 <= w['x.bn3.gamma'].min() and w['x.bn3.gamma'].max() < 0.36
    assert 0.4 <= w['x.bn1.var'].min() and w['x.bn1.var'].max() < 1.8


def test_seeds_share_one_base_network():
    spec = [('rpn.rpn_conv.weight', (512, 1024, 3, 3))]
    a = weights.make(spec, 11, 'cpu')['rpn.rpn_conv.weight']
    b = weights.make(spec, 2**40 + 3, 'cpu')['rpn.rpn_conv.weight']
    assert not torch.equal(a, b)
    ratio = a / b
    assert ratio.min() > 0.6 and ratio.max() < 1.5
    assert abs(float(torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[
        0, 1])) > 0.99
