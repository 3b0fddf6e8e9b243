"""Region proposal and region classification heads (counterpart of
`tpudenoise/models/rpn.py`).  Parameters are f32 and cast to the compute
dtype at use; outputs are f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    """Stride-1 SAME conv of an NCHW tensor in the compute dtype."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype), padding=layer.kernel_size[0] // 2)


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class RPNHead(nn.Module):
    """3x3 conv + relu, then 1x1 convs to 2A objectness logits and 4A box
    deltas.  Input NCHW features; outputs NHWC (B, H, W, 2A), (B, H, W, 4A).
    """

    def __init__(self, num_anchors: int = 9, channels: int = 512,
                 in_channels: int = 512, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.rpn_conv = nn.Conv2d(in_channels, channels, 3)
        self.rpn_cls_score = nn.Conv2d(channels, num_anchors * 2, 1)
        self.rpn_bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def reset_parameters(self, generator: torch.Generator):
        for layer in (self.rpn_conv, self.rpn_cls_score, self.rpn_bbox_pred):
            nn.init.normal_(layer.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, feat: torch.Tensor):
        x = F.relu(conv(feat, self.rpn_conv, self.dtype))
        cls = conv(x, self.rpn_cls_score, self.dtype)
        bbox = conv(x, self.rpn_bbox_pred, self.dtype)
        return (cls.permute(0, 2, 3, 1).float(),
                bbox.permute(0, 2, 3, 1).float())


def rpn_softmax_scores(rpn_cls: torch.Tensor, num_anchors: int
                       ) -> torch.Tensor:
    """(B, H, W, 2A) logits -> (B, H*W*A) positive-class probabilities:
    the softmax over each anchor's (neg, pos) pair, as
    exp(pos - logaddexp(neg, pos))."""
    neg, pos = rpn_cls[..., :num_anchors], rpn_cls[..., num_anchors:]
    score = torch.exp(pos - torch.logaddexp(neg, pos))
    return score.reshape(rpn_cls.shape[0], -1)


class RCNNHead(nn.Module):
    """cls_score Dense(num_classes) and bbox_pred Dense(4 * num_classes)."""

    def __init__(self, num_classes: int, in_features: int = 4096,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 4)

    def reset_parameters(self, generator: torch.Generator):
        nn.init.normal_(self.cls_score.weight, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.bbox_pred.weight, 0.0, 0.001,
                        generator=generator)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, fc7: torch.Tensor):
        return (dense(fc7, self.cls_score, self.dtype).float(),
                dense(fc7, self.bbox_pred, self.dtype).float())
