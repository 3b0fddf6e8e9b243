"""JAX parameter trees <-> the port's state dict (counterpart of
`tpudenoise/models/convert.py` and of `_merge_pretrained` in
`tpudenoise/train/solver.py`).

The tree is {'head', 'rpn', 'tail'} as `FasterRCNN.init` of the JAX
package returns it (numpy or jax arrays), or as the shared `.npz` layout
stores it (`load_params_npz`).  Conv kernels go HWIO -> OIHW, Dense
kernels (in, out) -> (out, in); fc6's rows keep the HWC flatten order of
(R, 7, 7, 512), which the port's tail reproduces.  The resnet trees
(`head/{conv1, conv1_bn, blockN/unit_K/{conv1..3, bn1..3, shortcut,
shortcut_bn}}`, `tail/tail/block4/...`) and the mobilenet trees
(`head/layer_0/{conv, bn}`, `head/layer_i/{depthwise, dw_bn, pointwise,
pw_bn}` for i in 1..11, `tail/tail/layer_{12,13}/...`) map name for name;
their convs have no bias (a depthwise kernel (3, 3, 1, C) becomes
(C, 1, 3, 3), a pointwise (1, 1, Cin, Cout) (Cout, Cin, 1, 1)) and their
BN statistics become state-dict entries (buffers in the head, parameters
in the tail, which training updates).

The `.npz` layout is flat keys 'tree/sub/.../leaf' -> array, as
`tpudenoise.models.convert.save_params_npz` writes it; `load_params_npz`
here reads it back without the JAX package, and `save_params_npz` here
writes the port's state dict in the same layout (`to_jax_flat`, the
inverse of `from_jax_params`), which the JAX package's `load_params_npz`
reads back into the tree its `init` makes.  `merge_pretrained` overlays
a partial tree (a backbone-only `.npz`) on the port's init state dict,
leaf for leaf: a conv or Dense kernel or bias is one weight or bias, and
a BN's gamma, beta, mean and var are four entries.

The TensorFlow sources (`convert_tf_slim_resnet`, `convert_tf_slim_vgg16`,
`convert_tf_slim_mobilenet`, `convert_ref_detector`; numpy copies of the
JAX package's) read the checkpoint through `models.tf_checkpoint`, which
needs no TensorFlow, and return the same {head, rpn, tail} numpy trees,
leaf for leaf and bit for bit; `save_tree_npz` writes them out.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from tpudenoise_torch.models.tf_checkpoint import CheckpointReader


def load_params_npz(path: str) -> dict:
    """The nested {'head', 'rpn', 'tail'} tree of numpy arrays stored in a
    `.npz` of flat 'a/b/.../leaf' keys."""
    with np.load(path) as data:
        return _unflatten({key: data[key] for key in data.files})


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


def _bn_backbone(sd, prefix, tree):
    """A resnet or mobilenet subtree: bias-free conv kernels ('kernel'
    only) and frozen BN statistics ('gamma', 'beta', 'mean', 'var'),
    nested by block and unit, or by layer."""
    for name, p in tree.items():
        if 'kernel' in p:
            if 'bias' in p:
                raise ValueError(f'{prefix}{name}: resnet and mobilenet '
                                 f'convs have no bias')
            sd[f'{prefix}{name}.weight'] = _t(p['kernel'], (3, 2, 0, 1))
        elif 'gamma' in p:
            for leaf in ('gamma', 'beta', 'mean', 'var'):
                sd[f'{prefix}{name}.{leaf}'] = _t(p[leaf])
        else:
            _bn_backbone(sd, f'{prefix}{name}.', p)


def from_jax_params(tree: dict) -> dict:
    """vgg16, res50/101/152 or mobile Faster R-CNN param tree -> state
    dict of `FasterRCNN`."""
    sd = {}
    head = tree['head']
    if 'block1' in head or 'layer_0' in head:  # resnet, mobilenet
        _bn_backbone(sd, 'head.', head)
        _bn_backbone(sd, 'tail.', tree['tail']['tail'])
    elif 'conv1_1' in head:                    # vgg16
        for name, p in head.items():
            _conv(sd, 'head.' + name, p)
        for name in ('fc6', 'fc7'):
            _dense(sd, 'tail.' + name, tree['tail']['tail'][name])
    else:
        raise ValueError(
            f'head layers {sorted(head)[:4]}: not a vgg16, resnet or '
            f'mobilenet tree')
    for name in ('rpn_conv', 'rpn_cls_score', 'rpn_bbox_pred'):
        _conv(sd, 'rpn.' + name, tree['rpn'][name])
    for name in ('cls_score', 'bbox_pred'):
        _dense(sd, 'rcnn.' + name, tree['tail']['rcnn'][name])
    return sd


def load_npz(path: str) -> dict:
    """A `.npz` written by `tpudenoise.models.convert.save_params_npz`."""
    return from_jax_params(load_params_npz(path))


# the state dict's top-level modules -> their path in the JAX tree
_TREE_PATH = {'head': ('head',), 'rpn': ('rpn',), 'tail': ('tail', 'tail'),
              'rcnn': ('tail', 'rcnn')}
# OIHW -> HWIO and (out, in) -> (in, out): inverses of from_jax_params'
_TO_JAX = {4: (2, 3, 1, 0), 2: (1, 0)}


def to_jax_flat(state_dict: dict) -> dict:
    """The port's state dict as the flat 'tree/sub/.../leaf' -> f32 numpy
    arrays of the shared `.npz` layout (the inverse of
    `from_jax_params`)."""
    flat = {}
    for name, t in state_dict.items():
        top, *mid, leaf = name.split('.')
        a = t.detach().to('cpu', torch.float32).numpy()
        if leaf == 'weight':
            leaf, a = 'kernel', np.transpose(a, _TO_JAX[a.ndim])
        flat['/'.join(_TREE_PATH[top] + tuple(mid) + (leaf,))] = \
            np.ascontiguousarray(a)
    return flat


def save_params_npz(state_dict: dict, path: str):
    """Write the port's state dict as a `.npz` in the shared layout."""
    np.savez(path, **to_jax_flat(state_dict))


def _flatten(tree: dict, prefix: str = '') -> dict:
    flat = {}
    for k, v in tree.items():
        name = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, name))
        else:
            flat[name] = v
    return flat


def _unflatten(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        *parts, leaf = key.split('/')
        d = out
        for p in parts:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def load_pretrained(path: str, net: str) -> dict:
    """The tree of a pretrained `.npz` (the only format the port reads).
    An orbax snapshot (`<path>.orbax`) must be converted on a host with
    JAX first: `tpudenoise.models.convert.save_params_npz` of its
    params."""
    if path.endswith('.npz'):
        return load_params_npz(path)
    if path.endswith('.orbax') or osp.exists(path + '.orbax'):
        raise ValueError(
            f'{path!r} is an orbax snapshot, which the port cannot read (no '
            f'orbax on the GPU machine): on a host with JAX, write its '
            f'params with tpudenoise.models.convert.save_params_npz and '
            f'pass the .npz.')
    raise ValueError(
        f'Unsupported weight file {path!r}: convert tf-slim/torch weights '
        f'to .npz first (tpudenoise.models.convert).')


def merge_pretrained(state_dict: dict, tree: dict) -> dict:
    """Overlay the leaves of a (partial) JAX-layout tree onto an init
    state dict where their paths match; returns the merged state dict.
    Prints the JAX package's two lines: the entries that matched no
    parameter (a converter emitting wrong names would otherwise leave
    random weights silently), and n/N loaded."""
    flat = to_jax_flat(state_dict)
    pre = _flatten(tree)
    unmatched = sorted((k for k in pre if k not in flat),
                       key=lambda k: k.split('/'))
    if unmatched:
        print(f'WARNING: {len(unmatched)} pretrained entries matched no '
              f'model parameter and were ignored, e.g. {unmatched[:10]}')
    n_hit = sum(1 for k in pre if k in flat)
    print(f'Loaded {n_hit}/{len(flat)} parameters from pretrained weights')
    return from_jax_params(_unflatten(
        {k: pre.get(k, v) for k, v in flat.items()}))


# --------------------------------------------------- source converters --

UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _bgr_flip_conv(w: np.ndarray) -> np.ndarray:
    """Reverse the input-channel axis of an HWIO conv kernel: the RGB ->
    BGR surgery on the first conv."""
    return w[:, :, ::-1, :]


# tf-slim ImageNet checkpoints and reference-trained detectors

def _reader(ckpt):
    """A `CheckpointReader` of the prefix ckpt (or ckpt, already one)."""
    return ckpt if isinstance(ckpt, CheckpointReader) else \
        CheckpointReader(ckpt)


def convert_tf_slim_resnet(ckpt_path, num_layers: int,
                           bgr_flip: bool = True) -> dict:
    """slim resnet_v1_{50,101,152} checkpoint -> the {'head', 'tail'}
    trees (`tpudenoise.models.convert.convert_tf_slim_resnet`).

    `resnet_v1_N/...` BatchNorm {gamma, beta, moving_mean,
    moving_variance} -> {gamma, beta, mean, var};
    `blockB/unit_K/bottleneck_v1/{conv1..3, shortcut}` ->
    `blockB/unit_K/{conv1..3, bn1..3, shortcut, shortcut_bn}`, block4
    under tail/tail.  conv1 is flipped to BGR unless bgr_flip=False (a
    reference-trained detector, flipped at its init).  ckpt_path: a
    checkpoint prefix or a `CheckpointReader`."""
    reader = _reader(ckpt_path)
    scope = f'resnet_v1_{num_layers}'
    units = UNITS[num_layers]

    def bn(prefix):
        return {'gamma': reader.get_tensor(prefix + '/gamma'),
                'beta': reader.get_tensor(prefix + '/beta'),
                'mean': reader.get_tensor(prefix + '/moving_mean'),
                'var': reader.get_tensor(prefix + '/moving_variance')}

    conv1 = reader.get_tensor(scope + '/conv1/weights')
    head = {'conv1': {'kernel':
                      _bgr_flip_conv(conv1) if bgr_flip else conv1},
            'conv1_bn': bn(scope + '/conv1/BatchNorm')}
    trees = {'head': head, 'tail': {'tail': {}}}
    for b in range(1, 5):
        block = {}
        for u in range(1, units[b - 1] + 1):
            base = f'{scope}/block{b}/unit_{u}/bottleneck_v1'
            unit = {}
            if reader.has_tensor(base + '/shortcut/weights'):
                unit['shortcut'] = {'kernel': reader.get_tensor(
                    base + '/shortcut/weights')}
                unit['shortcut_bn'] = bn(base + '/shortcut/BatchNorm')
            for i in (1, 2, 3):
                unit[f'conv{i}'] = {'kernel': reader.get_tensor(
                    f'{base}/conv{i}/weights')}
                unit[f'bn{i}'] = bn(f'{base}/conv{i}/BatchNorm')
            block[f'unit_{u}'] = unit
        dest = trees['head'] if b < 4 else trees['tail']['tail']
        dest[f'block{b}'] = block
    return trees


VGG_REPS = (2, 2, 3, 3, 3)


def convert_tf_slim_vgg16(ckpt_path) -> dict:
    """slim vgg_16 checkpoint -> {'head', 'tail'}: conv1_1 flipped to BGR,
    fc6 (7, 7, 512, 4096) and fc7 (1, 1, 4096, 4096) reshaped to dense
    kernels (`tpudenoise.models.convert.convert_tf_slim_vgg16`)."""
    reader = _reader(ckpt_path)
    head = {}
    for s, rep in enumerate(VGG_REPS, start=1):
        for r in range(1, rep + 1):
            w = reader.get_tensor(f'vgg_16/conv{s}/conv{s}_{r}/weights')
            b = reader.get_tensor(f'vgg_16/conv{s}/conv{s}_{r}/biases')
            if s == 1 and r == 1:
                w = _bgr_flip_conv(w)
            head[f'conv{s}_{r}'] = {'kernel': w, 'bias': b}
    tail = {'tail': {}}
    fc6 = reader.get_tensor('vgg_16/fc6/weights')
    tail['tail']['fc6'] = {'kernel': fc6.reshape(-1, 4096),
                           'bias': reader.get_tensor('vgg_16/fc6/biases')}
    fc7 = reader.get_tensor('vgg_16/fc7/weights')
    tail['tail']['fc7'] = {'kernel': fc7.reshape(4096, 4096),
                           'bias': reader.get_tensor('vgg_16/fc7/biases')}
    return {'head': head, 'tail': tail}


def convert_tf_slim_mobilenet(ckpt_path, depth_multiplier: float = 1.0,
                              surgery: bool = True) -> dict:
    """slim MobilenetV1 checkpoint -> {'head', 'tail'}
    (`tpudenoise.models.convert.convert_tf_slim_mobilenet`).

    `MobilenetV1/Conv2d_0/{weights, BatchNorm}` -> `layer_0/{conv, bn}`;
    `Conv2d_i_depthwise/depthwise_weights` (k, k, C, 1) ->
    `layer_i/depthwise` (k, k, 1, C); `Conv2d_i_pointwise/weights` ->
    `layer_i/pointwise`; layers 12 and 13 under tail/tail.  surgery=True
    is the reference's fix of ImageNet weights: Conv2d_0 flipped to BGR
    and divided by 255 / 2 (slim mobilenets take [-1, 1] inputs); False
    for a reference-trained detector.  depth_multiplier is unused, as in
    the JAX package."""
    reader = _reader(ckpt_path)
    scope = 'MobilenetV1'

    def bn(prefix):
        return {'gamma': reader.get_tensor(prefix + '/BatchNorm/gamma'),
                'beta': reader.get_tensor(prefix + '/BatchNorm/beta'),
                'mean': reader.get_tensor(
                    prefix + '/BatchNorm/moving_mean'),
                'var': reader.get_tensor(
                    prefix + '/BatchNorm/moving_variance')}

    conv0 = reader.get_tensor(scope + '/Conv2d_0/weights')
    if surgery:
        conv0 = _bgr_flip_conv(conv0) / (255.0 / 2.0)
    layers = {'layer_0': {'conv': {'kernel': conv0},
                          'bn': bn(scope + '/Conv2d_0')}}
    for i in range(1, 14):
        dw = reader.get_tensor(
            f'{scope}/Conv2d_{i}_depthwise/depthwise_weights')
        layers[f'layer_{i}'] = {
            'depthwise': {'kernel': np.transpose(dw, (0, 1, 3, 2))},
            'dw_bn': bn(f'{scope}/Conv2d_{i}_depthwise'),
            'pointwise': {'kernel': reader.get_tensor(
                f'{scope}/Conv2d_{i}_pointwise/weights')},
            'pw_bn': bn(f'{scope}/Conv2d_{i}_pointwise'),
        }
    head = {k: layers[k] for k in [f'layer_{i}' for i in range(12)]}
    tail = {'tail': {f'layer_{i}': layers[f'layer_{i}'] for i in (12, 13)}}
    return {'head': head, 'tail': tail}


DETECTOR_SCOPES = {'vgg16': 'vgg_16', 'res50': 'resnet_v1_50',
                   'res101': 'resnet_v1_101', 'res152': 'resnet_v1_152',
                   'mobile': 'MobilenetV1'}


def convert_ref_detector(ckpt_path, net: str) -> dict:
    """Reference-trained Faster R-CNN checkpoint -> the full {head, rpn,
    tail} tree (`tpudenoise.models.convert.convert_ref_detector`).

    The backbone scope as its converter reads it, without surgery (a
    trained checkpoint's conv1 is BGR, its mobilenet scaled, its vgg16
    fc6/fc7 dense), then `{scope}/rpn_conv/3x3`, `rpn_cls_score`,
    `rpn_bbox_pred` -> rpn and `{scope}/cls_score`, `bbox_pred` ->
    tail/rcnn, each {weights, biases} -> {kernel, bias}; bbox_pred stays
    un-normalized, as the reference stores it."""
    reader = _reader(ckpt_path)
    scope = DETECTOR_SCOPES[net]
    if net == 'vgg16':
        trees = _vgg_detector_backbone(reader, scope)
    elif net in ('res50', 'res101', 'res152'):
        trees = convert_tf_slim_resnet(reader, int(net[3:]), bgr_flip=False)
    elif net == 'mobile':
        trees = convert_tf_slim_mobilenet(reader, surgery=False)
    else:
        raise ValueError(f'unknown net {net!r}')

    def wb(name):
        return {'kernel': reader.get_tensor(f'{scope}/{name}/weights'),
                'bias': reader.get_tensor(f'{scope}/{name}/biases')}

    trees['rpn'] = {'rpn_conv': wb('rpn_conv/3x3'),
                    'rpn_cls_score': wb('rpn_cls_score'),
                    'rpn_bbox_pred': wb('rpn_bbox_pred')}
    trees['tail']['rcnn'] = {'cls_score': wb('cls_score'),
                             'bbox_pred': wb('bbox_pred')}
    return trees


def _vgg_detector_backbone(reader, scope: str) -> dict:
    """vgg_16 of a trained detector: the convs as stored (already BGR),
    fc6/fc7 dense (a conv-layout fc is reshaped to (-1, out))."""
    head = {}
    for s, rep in enumerate(VGG_REPS, start=1):
        for r in range(1, rep + 1):
            head[f'conv{s}_{r}'] = {
                'kernel': reader.get_tensor(
                    f'{scope}/conv{s}/conv{s}_{r}/weights'),
                'bias': reader.get_tensor(
                    f'{scope}/conv{s}/conv{s}_{r}/biases')}
    tail = {'tail': {}}
    for fc in ('fc6', 'fc7'):
        w = reader.get_tensor(f'{scope}/{fc}/weights')
        if w.ndim == 4:
            w = w.reshape(-1, w.shape[-1])
        tail['tail'][fc] = {
            'kernel': w,
            'bias': reader.get_tensor(f'{scope}/{fc}/biases')}
    return {'head': head, 'tail': tail}


# torchvision resnets

def convert_torch_resnet(state_dict: dict, num_layers: int) -> dict:
    """torchvision resnet{50,101,152} state dict (numpy arrays) -> the
    {'head', 'tail'} trees of the JAX layout (a numpy copy of
    `tpudenoise.models.convert.convert_torch_resnet`).

    OIHW conv kernels -> HWIO, conv1's input channels flipped to BGR; BN
    weight, bias, running_mean and running_var -> gamma, beta, mean and
    var; layer{b}.{k} -> block{b}/unit_{k+1}, downsample -> shortcut.
    torchvision strides the first unit of a layer where slim (and both
    packages) stride the last: the weights map all the same, but the
    features differ from a slim checkpoint's.  The normalization of
    torchvision's [0, 1] RGB inputs is not folded into conv1."""
    units = UNITS[num_layers]

    def conv(name):
        w = np.asarray(state_dict[name + '.weight'])
        return {'kernel': np.transpose(w, (2, 3, 1, 0))}

    def bn(name):
        return {'gamma': np.asarray(state_dict[name + '.weight']),
                'beta': np.asarray(state_dict[name + '.bias']),
                'mean': np.asarray(state_dict[name + '.running_mean']),
                'var': np.asarray(state_dict[name + '.running_var'])}

    head = {'conv1': {'kernel': _bgr_flip_conv(conv('conv1')['kernel'])},
            'conv1_bn': bn('bn1')}
    trees = {'head': head, 'tail': {'tail': {}}}
    for b in range(1, 5):
        block = {}
        for u in range(units[b - 1]):
            base = f'layer{b}.{u}'
            unit = {}
            if base + '.downsample.0.weight' in state_dict:
                unit['shortcut'] = conv(base + '.downsample.0')
                unit['shortcut_bn'] = bn(base + '.downsample.1')
            for i in (1, 2, 3):
                unit[f'conv{i}'] = conv(f'{base}.conv{i}')
                unit[f'bn{i}'] = bn(f'{base}.bn{i}')
            block[f'unit_{u + 1}'] = unit
        dest = trees['head'] if b < 4 else trees['tail']['tail']
        dest[f'block{b}'] = block
    return trees


def save_tree_npz(tree: dict, path: str):
    """Write a JAX-layout tree (nested dicts of arrays) as the `.npz` of
    flat 'tree/sub/.../leaf' keys, in the tree's order, as
    `tpudenoise.models.convert.save_params_npz` writes it."""
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(tree).items()})
