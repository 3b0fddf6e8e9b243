"""JAX parameter trees -> the port's state dict (counterpart of
`tpudenoise/models/convert.py`).

The tree is {'head', 'rpn', 'tail'} as `FasterRCNN.init` of the JAX
package returns it (numpy or jax arrays), or as the shared `.npz` layout
stores it (`load_params_npz`).  Conv kernels go HWIO -> OIHW, Dense
kernels (in, out) -> (out, in); fc6's rows keep the HWC flatten order of
(R, 7, 7, 512), which the port's tail reproduces.  The resnet trees
(`head/{conv1, conv1_bn, blockN/unit_K/{conv1..3, bn1..3, shortcut,
shortcut_bn}}`, `tail/tail/block4/...`) map name for name; their convs have
no bias and their BN statistics become buffers.

The `.npz` layout is flat keys 'tree/sub/.../leaf' -> array, as
`tpudenoise.models.convert.save_params_npz` writes it; `load_params_npz`
here reads it back without the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def load_params_npz(path: str) -> dict:
    """The nested {'head', 'rpn', 'tail'} tree of numpy arrays stored in a
    `.npz` of flat 'a/b/.../leaf' keys."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split('/')
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = data[key]
    return out


def _t(a, transpose=None) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if transpose is not None:
        a = np.transpose(a, transpose)
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(sd, name, p):
    sd[name + '.weight'] = _t(p['kernel'], (3, 2, 0, 1))
    sd[name + '.bias'] = _t(p['bias'])


def _dense(sd, name, p):
    sd[name + '.weight'] = _t(p['kernel'], (1, 0))
    sd[name + '.bias'] = _t(p['bias'])


def _resnet(sd, prefix, tree):
    """A resnet subtree: bias-free conv kernels ('kernel' only) and frozen
    BN statistics ('gamma', 'beta', 'mean', 'var'), nested by block and
    unit."""
    for name, p in tree.items():
        if 'kernel' in p:
            if 'bias' in p:
                raise ValueError(f'{prefix}{name}: resnet convs have no bias')
            sd[f'{prefix}{name}.weight'] = _t(p['kernel'], (3, 2, 0, 1))
        elif 'gamma' in p:
            for leaf in ('gamma', 'beta', 'mean', 'var'):
                sd[f'{prefix}{name}.{leaf}'] = _t(p[leaf])
        else:
            _resnet(sd, f'{prefix}{name}.', p)


def from_jax_params(tree: dict) -> dict:
    """vgg16 or res50/101/152 Faster R-CNN param tree -> state dict of
    `FasterRCNN`."""
    sd = {}
    head = tree['head']
    if 'block1' in head:                       # resnet
        _resnet(sd, 'head.', head)
        _resnet(sd, 'tail.', tree['tail']['tail'])
    elif 'conv1_1' in head:                    # vgg16
        for name, p in head.items():
            _conv(sd, 'head.' + name, p)
        for name in ('fc6', 'fc7'):
            _dense(sd, 'tail.' + name, tree['tail']['tail'][name])
    else:
        raise NotImplementedError(
            f'head layers {sorted(head)[:4]}: only the vgg16 and resnet '
            f'backbones are ported (mobilenet is ROADMAP Queue 1 item 15)')
    for name in ('rpn_conv', 'rpn_cls_score', 'rpn_bbox_pred'):
        _conv(sd, 'rpn.' + name, tree['rpn'][name])
    for name in ('cls_score', 'bbox_pred'):
        _dense(sd, 'rcnn.' + name, tree['tail']['rcnn'][name])
    return sd


def load_npz(path: str) -> dict:
    """A `.npz` written by `tpudenoise.models.convert.save_params_npz`."""
    return from_jax_params(load_params_npz(path))
