"""ResNet-v1 50/101/152 backbones (counterpart of
`tpudenoise/models/backbones/resnet.py`): the stride-16 head (root conv,
max-pool, blocks 1-3 with block3 at stride 1, 1024 channels) and the RoI
tail (block4 at stride 1, then the mean over H and W: (R, 2048)).

NCHW modules in channels-last memory, as `vgg.py`.  Convs have no bias;
BN is a loaded affine whose statistics no batch updates.  In the head its
gamma, beta, mean and var are buffers (frozen, as the JAX step's
`frozen_param_filter` keeps them); in the tail (block4) they are
parameters, because the JAX step's freeze filter covers the 'head' tree
only and so trains them by the gradient of the affine
(`tpudenoise/train/train_step.py:125`).  Parameters are f32 and cast to
the compute dtype at use.  `frozen_param_filter` gives the training
freeze boundaries (RESNET.FIXED_BLOCKS and FREEZE_ROOT).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudenoise_torch.models.backbones.vgg import lecun_normal_
from tpudenoise_torch.models.rpn import conv, no_default_init

BLOCK_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FrozenBatchNorm(nn.Module):
    """BN with loaded statistics that no batch updates: scale and bias are
    computed in f32 from gamma, beta, mean and var, cast to the compute
    dtype, and `x * scale + bias` runs in that dtype.  The four are
    buffers (in the state dict, never trained), or parameters when
    `trainable` (the tail's: SGD moves them through the affine)."""

    IDENTITY = (('gamma', 1.0), ('beta', 0.0), ('mean', 0.0), ('var', 1.0))

    def __init__(self, channels: int, dtype=torch.bfloat16,
                 trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        for name, fill in self.IDENTITY:
            t = torch.full((channels,), fill)
            if trainable:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    @torch.no_grad()
    def reset_parameters(self):
        for name, fill in self.IDENTITY:
            getattr(self, name).fill_(fill)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.var + 1e-5)
        scale = (self.gamma / root).to(self.dtype)
        bias = (self.beta - self.mean * self.gamma / root).to(self.dtype)
        return x * scale[:, None, None] + bias[:, None, None]


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return no_default_init(nn.Conv2d, cin, cout, k, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with a 4x expansion.  The shortcut is a
    strided 1x1 conv + BN where the depth changes, else the identity,
    subsampled as x[:, :, ::s, ::s] when strided."""

    def __init__(self, depth_in: int, depth_bottleneck: int, stride: int,
                 dtype=torch.bfloat16, trainable_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        depth = 4 * depth_bottleneck

        def bn(channels):
            return FrozenBatchNorm(channels, dtype, trainable_bn)

        if depth_in != depth:
            self.shortcut = _conv(depth_in, depth, 1)
            self.shortcut_bn = bn(depth)
        self.conv1 = _conv(depth_in, depth_bottleneck, 1)
        self.bn1 = bn(depth_bottleneck)
        self.conv2 = _conv(depth_bottleneck, depth_bottleneck, 3)
        self.bn2 = bn(depth_bottleneck)
        self.conv3 = _conv(depth_bottleneck, depth, 1)
        self.bn3 = bn(depth)

    def forward(self, x: torch.Tensor, record=None, name: str = ''
                ) -> torch.Tensor:
        """record(name + '/conv3', tensor), when given, receives conv3's
        output before its BN (the TwoNN probes)."""
        if hasattr(self, 'shortcut'):
            sc = self.shortcut_bn(conv(x, self.shortcut, self.dtype,
                                       self.stride))
        else:
            sc = x[:, :, ::self.stride, ::self.stride]
        r = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        r = F.relu(self.bn2(conv(r, self.conv2, self.dtype, self.stride)))
        r = conv(r, self.conv3, self.dtype)
        if record is not None:
            record(name + '/conv3', r)
        return F.relu(sc + self.bn3(r))


class ResNetBlock(nn.Sequential):
    """slim's resnet_v1_block: `num_units` bottlenecks named unit_1 ..,
    the stride on the LAST unit."""

    def __init__(self, depth_in: int, base_depth: int, num_units: int,
                 stride: int, dtype=torch.bfloat16,
                 trainable_bn: bool = False):
        super().__init__()
        for i in range(num_units):
            self.add_module(f'unit_{i + 1}', Bottleneck(
                depth_in if i == 0 else 4 * base_depth, base_depth,
                stride if i == num_units - 1 else 1, dtype, trainable_bn))

    def forward(self, x: torch.Tensor, record=None, name: str = ''
                ) -> torch.Tensor:
        """The units in order; record as `Bottleneck.forward`, each unit
        named name + '/unit_i'."""
        for unit_name, unit in self.named_children():
            x = unit(x, record, f'{name}/{unit_name}')
        return x


def reset_resnet(module: nn.Module, generator: torch.Generator):
    """The seeded init: flax's lecun-normal conv kernels, identity BN, and
    every conv3 kernel zeroed (`resnet.zero_init_residual`: each residual
    unit starts as the identity, so a seeded res101 does not grow its
    activations through 33 residual sums)."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            if name.endswith('conv3'):
                nn.init.zeros_(m.weight)
            else:
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, FrozenBatchNorm):
            m.reset_parameters()


class ResNetHead(nn.Module):
    """NCHW (B, 3, H, W) -> (B, 1024, H/16, W/16) in the compute dtype:
    7x7/2 conv, BN, ReLU, 3x3/2 max-pool, blocks 1-3."""

    def __init__(self, num_layers: int = 101, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        units = BLOCK_UNITS[num_layers]
        self.conv1 = _conv(3, 64, 7)
        self.conv1_bn = FrozenBatchNorm(64, dtype)
        self.block1 = ResNetBlock(64, 64, units[0], 2, dtype)
        self.block2 = ResNetBlock(256, 128, units[1], 2, dtype)
        self.block3 = ResNetBlock(512, 256, units[2], 1, dtype)

    def reset_parameters(self, generator: torch.Generator):
        reset_resnet(self, generator)

    def forward(self, x: torch.Tensor, record=None) -> torch.Tensor:
        """record(name, tensor), when given, receives each unit's conv3
        output before its BN, as 'block1/unit_1/conv3' (the TwoNN
        probes)."""
        x = F.relu(self.conv1_bn(conv(x, self.conv1, self.dtype, 2)))
        # the reference zero-pads (1, 1) and pools 3x3/2 VALID; after the
        # ReLU every window holds a value >= 0, so max_pool2d's -inf
        # padding gives the same maximum
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in ('block1', 'block2', 'block3'):
            x = getattr(self, name)(x, record, name)
        return x


class ResNetTail(nn.Module):
    """(R, 7, 7, 1024) NHWC RoIs -> block4 at stride 1 -> the mean over
    H and W, (R, 2048), rounded to the compute dtype as jnp.mean rounds
    it.  block4's BN gamma, beta, mean and var are parameters: the JAX
    step trains them (see the module docstring)."""

    def __init__(self, num_layers: int = 101, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.block4 = ResNetBlock(1024, 512, BLOCK_UNITS[num_layers][3], 1,
                                  dtype, trainable_bn=True)

    def reset_parameters(self, generator: torch.Generator):
        reset_resnet(self, generator)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = self.block4(rois.to(self.dtype).permute(0, 3, 1, 2))
        return x.float().mean(dim=(2, 3)).to(self.dtype)


def frozen_param_filter(num_fixed_blocks: int = 1, freeze_root: bool = True):
    """A predicate over a head parameter's path below 'head': BN frozen
    (in the head its statistics are buffers, never trained), the root
    conv when freeze_root, and the first num_fixed_blocks blocks.  As in
    the JAX step, it covers the head only: the tail's BN trains."""
    fixed_blocks = {f'block{i + 1}' for i in range(num_fixed_blocks)}

    def is_frozen(path) -> bool:
        parts = [str(p) for p in path]
        if any('bn' in p for p in parts):
            return True
        if freeze_root and parts and parts[0] in ('conv1', 'conv1_bn'):
            return True
        return bool(parts) and parts[0] in fixed_blocks

    return is_frozen
