"""MobileNetV1 backbone (counterpart of
`tpudenoise/models/backbones/mobilenet.py`): one full 3x3 conv and 13
depthwise-separable layers; the detector's head is layers 0-11 (stride
16, `_depth(512)` channels) and its RoI tail layers 12-13 (the stride-2
1024-wide pair), then the mean over H and W.  The depth multiplier
scales every width (at least 8).

A full layer is conv -> bn -> ReLU6; a depthwise layer is the depthwise
3x3 (`groups=C`, no bias) -> dw_bn -> ReLU6 -> the pointwise 1x1 ->
pw_bn -> ReLU6.  Every conv pads 1 on each side: the JAX package pads
its stride-2 layers symmetrically (`_same_pad`, slim's conv2d_same),
which for k=3 is not TensorFlow's SAME (that pads (0, 1) on even
extents), and its stride-1 layers SAME, also 1/1 for k=3.

NCHW modules in channels-last memory, as `resnet.py`; the convs (the
depthwise ones included) are cuDNN's.  BN is resnet's `FrozenBatchNorm`
(as the JAX file imports resnet's): buffers in the head, parameters in
the tail, which the JAX step trains because its freeze filter covers the
'head' tree only.  `frozen_param_filter` freezes the first FIXED_LAYERS
layers and every BN.
"""

from __future__ import annotations

import torch
from torch import nn

from tpudenoise_torch.models.backbones.resnet import FrozenBatchNorm
from tpudenoise_torch.models.backbones.vgg import lecun_normal_
from tpudenoise_torch.models.rpn import conv, no_default_init

# (kernel, stride, out_channels, depthwise?)
CONV_DEFS = [
    (3, 2, 32, False),
    (3, 1, 64, True), (3, 2, 128, True), (3, 1, 128, True),
    (3, 2, 256, True), (3, 1, 256, True), (3, 2, 512, True),
    (3, 1, 512, True), (3, 1, 512, True), (3, 1, 512, True),
    (3, 1, 512, True), (3, 1, 512, True),          # layers 0..11: head
    (3, 2, 1024, True), (3, 1, 1024, True),        # layers 12..13: tail
]
HEAD_LAYERS = 12


def _depth(ch: int, multiplier: float) -> int:
    return max(int(ch * multiplier), 8)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6) in x's dtype (flax's relu6)."""
    return x.clamp(0.0, 6.0)


class _Layer(nn.Module):
    """One row of CONV_DEFS from cin channels."""

    def __init__(self, cin: int, kernel: int, stride: int, out_ch: int,
                 depthwise: bool, dtype=torch.bfloat16,
                 trainable_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        if depthwise:
            self.depthwise = no_default_init(nn.Conv2d, cin, cin, kernel,
                                             groups=cin, bias=False)
            self.dw_bn = FrozenBatchNorm(cin, dtype, trainable_bn)
            self.pointwise = no_default_init(nn.Conv2d, cin, out_ch, 1,
                                             bias=False)
            self.pw_bn = FrozenBatchNorm(out_ch, dtype, trainable_bn)
        else:
            self.conv = no_default_init(nn.Conv2d, cin, out_ch, kernel,
                                        bias=False)
            self.bn = FrozenBatchNorm(out_ch, dtype, trainable_bn)

    def forward(self, x: torch.Tensor, record=None, name: str = ''
                ) -> torch.Tensor:
        """record(name + '/pointwise', tensor), when given, receives the
        pointwise conv's output before pw_bn (the TwoNN probes)."""
        if not hasattr(self, 'depthwise'):
            return relu6(self.bn(conv(x, self.conv, self.dtype,
                                      self.stride)))
        x = relu6(self.dw_bn(conv(x, self.depthwise, self.dtype,
                                  self.stride)))
        x = conv(x, self.pointwise, self.dtype)
        if record is not None:
            record(name + '/pointwise', x)
        return relu6(self.pw_bn(x))


def _layers(module: nn.Module, first: int, last: int, cin: int,
            multiplier: float, dtype, trainable_bn: bool) -> int:
    """Add layer_first .. layer_{last - 1} to module; returns their
    output channels."""
    for i in range(first, last):
        k, s, ch, dw = CONV_DEFS[i]
        out = _depth(ch, multiplier)
        module.add_module(f'layer_{i}', _Layer(cin, k, s, out, dw, dtype,
                                               trainable_bn))
        cin = out
    return cin


def reset_mobilenet(module: nn.Module, generator: torch.Generator):
    """The seeded init: flax's lecun-normal conv kernels (fan-in
    kh * kw * in-channels-per-group: 9 for a depthwise kernel) and
    identity BN, as the JAX init."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, FrozenBatchNorm):
            m.reset_parameters()


class MobileNetV1Head(nn.Module):
    """NCHW (B, 3, H, W) -> (B, _depth(512), H/16, W/16) in the compute
    dtype: layers 0-11."""

    def __init__(self, depth_multiplier: float = 1.0, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.out_channels = _layers(self, 0, HEAD_LAYERS, 3,
                                    depth_multiplier, dtype, False)

    def reset_parameters(self, generator: torch.Generator):
        reset_mobilenet(self, generator)

    def forward(self, x: torch.Tensor, record=None) -> torch.Tensor:
        """record(name, tensor), when given, receives each depthwise
        layer's pointwise output before its BN, as 'layer_1/pointwise'."""
        x = x.to(self.dtype)
        for name, layer in self.named_children():
            x = layer(x, record, name)
        return x


class MobileNetV1Tail(nn.Module):
    """(R, 7, 7, C) NHWC RoIs -> layers 12-13 -> the mean over H and W,
    (R, _depth(1024)), summed in f32 and rounded once to the compute
    dtype as jnp.mean of a bf16 array.  Its BN entries are parameters
    (see the module docstring)."""

    def __init__(self, depth_multiplier: float = 1.0, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.out_channels = _layers(
            self, HEAD_LAYERS, len(CONV_DEFS),
            _depth(CONV_DEFS[HEAD_LAYERS - 1][2], depth_multiplier),
            depth_multiplier, dtype, True)

    def reset_parameters(self, generator: torch.Generator):
        reset_mobilenet(self, generator)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = rois.to(self.dtype).permute(0, 3, 1, 2)
        for layer in self.children():
            x = layer(x)
        return x.float().mean(dim=(2, 3)).to(self.dtype)


def frozen_param_filter(num_fixed_layers: int = 5):
    """A predicate over a head parameter's path below 'head': the first
    num_fixed_layers layers, and every parameter whose path has 'bn' in
    it (in the head the BN statistics are buffers, never trained)."""
    fixed = {f'layer_{i}' for i in range(num_fixed_layers)}

    def is_frozen(path) -> bool:
        parts = [str(p) for p in path]
        if any('bn' in p for p in parts):
            return True
        return bool(parts) and parts[0] in fixed

    return is_frozen
