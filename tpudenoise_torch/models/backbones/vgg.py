"""VGG16 backbone (counterpart of `tpudenoise/models/backbones/vgg.py`):
13 convs with 2x2 SAME max-pools after stages 1-4 (stride 16, 512
channels), and the fc6/fc7 4096 tail over 7x7x512 pooled RoIs."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudenoise_torch.models.rpn import conv, dense

STAGES = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator):
    """flax's default kernel init: truncated normal (2 sigma) with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class VGG16Head(nn.Module):
    """NCHW (B, 3, H, W) -> (B, 512, H/16, W/16) in the compute dtype."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for si, (reps, width) in enumerate(STAGES):
            for ri in range(reps):
                self.add_module(f'conv{si + 1}_{ri + 1}',
                                nn.Conv2d(cin, width, 3))
                cin = width

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.children():
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for si, (reps, _) in enumerate(STAGES):
            for ri in range(reps):
                x = F.relu(conv(x, getattr(self, f'conv{si + 1}_{ri + 1}'),
                                self.dtype))
            if si < 4:   # flax SAME == ceil_mode for odd extents
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x


class VGG16Tail(nn.Module):
    """fc6/fc7 4096 + relu over (R, 7, 7, 512) RoIs, flattened in HWC
    order as the JAX tail flattens NHWC (fc6 rows keep that order)."""

    def __init__(self, pool: int = 7, channels: int = 512,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc6 = nn.Linear(pool * pool * channels, 4096)
        self.fc7 = nn.Linear(4096, 4096)

    def reset_parameters(self, generator: torch.Generator):
        for layer in (self.fc6, self.fc7):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = rois.to(self.dtype).reshape(rois.shape[0], -1)
        x = F.relu(dense(x, self.fc6, self.dtype))
        return F.relu(dense(x, self.fc7, self.dtype))
