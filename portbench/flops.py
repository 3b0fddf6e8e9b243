"""The detector's model FLOPs per image (2 per multiply-add) at a
configuration's shapes: the backbone over the bucket, the RPN over the
stride-16 map, the tail and the heads over RPN_POST_NMS_TOP_N rois.
Counted from the architecture, never from kernel times; the crops, the
softmax and the elementwise work are left out."""

from __future__ import annotations

import math

RES101 = ((64, 3, 2), (128, 4, 2), (256, 23, 1), (512, 3, 1))
VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _down(h: int, w: int, s: int) -> tuple:
    return math.ceil(h / s), math.ceil(w / s)


def _resnet_block(h, w, din, base, units, stride) -> tuple:
    """(MACs, h, w, depth out) of one block, the stride on its last
    unit."""
    macs = 0
    for i in range(units):
        s = stride if i == units - 1 else 1
        ho, wo = _down(h, w, s)
        macs += h * w * din * base                 # conv1 1x1
        macs += ho * wo * base * base * 9          # conv2 3x3 / s
        macs += ho * wo * base * 4 * base          # conv3 1x1
        if din != 4 * base:
            macs += ho * wo * din * 4 * base       # shortcut 1x1 / s
        h, w, din = ho, wo, 4 * base
    return macs, h, w, din


def parts(cfg: dict) -> dict:
    """MACs per image by part: 'backbone', 'rpn', 'tail', 'heads'."""
    h, w = cfg['bucket']
    rois = cfg['rpn_post_nms_top_n']
    a = len(cfg['anchor_scales']) * len(cfg['anchor_ratios'])
    c = cfg['num_classes']
    pool = cfg['pooling_size']
    out = {}
    if cfg['net'] == 'vgg16':
        macs, cin = 0, 3
        for si, (reps, cout) in enumerate(VGG16):
            for _ in range(reps):
                macs += h * w * cin * cout * 9
                cin = cout
            if si < 4:
                h, w = _down(h, w, 2)
        out['backbone'], feat, fc = macs, 512, 4096
        out['tail'] = rois * (pool * pool * 512 * 4096 + 4096 * 4096)
    else:
        h, w = _down(h, w, 2)
        macs = h * w * 3 * 64 * 49                 # conv1 7x7 / 2
        h, w = _down(h, w, 2)                      # max-pool 3x3 / 2
        din = 64
        for base, units, stride in RES101[:3]:
            m, h, w, din = _resnet_block(h, w, din, base, units, stride)
            macs += m
        out['backbone'], feat, fc = macs, 1024, 2048
        base, units, stride = RES101[3]
        out['tail'] = rois * _resnet_block(pool, pool, 1024, base, units,
                                           stride)[0]
    rpn_c = cfg['rpn_channels']
    out['rpn'] = h * w * (feat * rpn_c * 9 + rpn_c * 6 * a)
    out['heads'] = rois * fc * 5 * c
    return out


def per_image(cfg: dict) -> float:
    """Model FLOPs of one image."""
    return 2.0 * sum(parts(cfg).values())
