"""JAX parameter trees -> the port's state dict (counterpart of
`tpudenoise/models/convert.py`).

The tree is {'head', 'rpn', 'tail'} as `FasterRCNN.init` of the JAX
package returns it (numpy or jax arrays), or as the shared `.npz` layout
stores it (`load_params_npz`).  Conv kernels go HWIO -> OIHW, Dense
kernels (in, out) -> (out, in); fc6's rows keep the HWC flatten order of
(R, 7, 7, 512), which the port's tail reproduces.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise.models.convert import load_params_npz


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


def from_jax_params(tree: dict) -> dict:
    """vgg16 Faster R-CNN param tree -> state dict of `FasterRCNN`."""
    sd = {}
    for name, p in tree['head'].items():
        if not name.startswith('conv'):
            raise NotImplementedError(
                f'head layer {name!r}: only the vgg16 backbone is ported '
                f'(ROADMAP Queue 1 item 5)')
        _conv(sd, 'head.' + name, p)
    for name in ('rpn_conv', 'rpn_cls_score', 'rpn_bbox_pred'):
        _conv(sd, 'rpn.' + name, tree['rpn'][name])
    for name in ('fc6', 'fc7'):
        _dense(sd, 'tail.' + name, tree['tail']['tail'][name])
    for name in ('cls_score', 'bbox_pred'):
        _dense(sd, 'rcnn.' + name, tree['tail']['rcnn'][name])
    return sd


def load_npz(path: str) -> dict:
    """A `.npz` written by `tpudenoise.models.convert.save_params_npz`."""
    return from_jax_params(load_params_npz(path))
