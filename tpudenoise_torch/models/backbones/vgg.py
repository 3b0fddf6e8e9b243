"""VGG16 backbone (counterpart of `tpudenoise/models/backbones/vgg.py`):
13 convs with 2x2 SAME max-pools after stages 1-4 (stride 16, 512
channels), and the fc6/fc7 4096 tail over 7x7x512 pooled RoIs, with
dropout 0.5 after each in training.  conv1_* and conv2_* are frozen
(`frozen_param_filter`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudenoise_torch.core import prng
from tpudenoise_torch.models.rpn import conv, dense, no_default_init

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
                                no_default_init(nn.Conv2d, cin, width, 3))
                cin = width

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.children():
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, record=None) -> torch.Tensor:
        """record(name, tensor), when given, receives each conv's output
        before its ReLU, by layer name (the TwoNN probes)."""
        x = x.to(self.dtype)
        for si, (reps, _) in enumerate(STAGES):
            for ri in range(reps):
                name = f'conv{si + 1}_{ri + 1}'
                x = conv(x, getattr(self, name), self.dtype)
                if record is not None:
                    record(name, x)
                x = F.relu(x)
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
        self.fc6 = no_default_init(nn.Linear, pool * pool * channels, 4096)
        self.fc7 = no_default_init(nn.Linear, 4096, 4096)

    def reset_parameters(self, generator: torch.Generator):
        for layer in (self.fc6, self.fc7):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, rois: torch.Tensor, dropout_keys=None) -> torch.Tensor:
        """rois (B*R, 7, 7, 512), image-major.  With dropout_keys (one
        (2,) key per image, (B, 2)), training mode: dropout after fc6 and
        fc7."""
        x = rois.to(self.dtype).reshape(rois.shape[0], -1)
        x = F.relu(dense(x, self.fc6, self.dtype))
        if dropout_keys is not None:
            x = dropout(x, dropout_keys, 'Dropout_0')
        x = F.relu(dense(x, self.fc7, self.dtype))
        if dropout_keys is not None:
            x = dropout(x, dropout_keys, 'Dropout_1')
        return x


KEEP = 0.5      # the tail's Dropout(0.5)


def dropout(x: torch.Tensor, keys, name: str) -> torch.Tensor:
    """flax's `Dropout(0.5)` in training mode over (B*R, F) rows, image
    by image: the keep mask is `uniform < KEEP` drawn (threefry kernel on
    a GPU) from the layer's flax rng, flax's fold of the module path
    ('tail', name) and the draw count 1 into each image's key, over that
    image's R*F elements; kept values are x / KEEP in x's dtype, the
    rest 0."""
    keys = prng.key_data(keys).reshape(-1, 2)
    u = prng.draw_uniform(prng.fold_in_path(keys, ('tail', name, 1)),
                          x.numel() // keys.shape[0], x.device)
    return torch.where((u < KEEP).reshape(x.shape), x / KEEP, 0.0)


def frozen_param_filter():
    """conv1_* and conv2_* frozen: a predicate over a head parameter's
    path below 'head' (module names, then the leaf)."""

    def is_frozen(path) -> bool:
        return bool(path) and (path[0].startswith('conv1_')
                               or path[0].startswith('conv2_'))

    return is_frozen
