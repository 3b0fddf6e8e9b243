"""Detection losses (counterpart of `tpudenoise/train/losses.py`): smooth-L1
with the sigma formulation (3.0 RPN, 1.0 RCNN) and masked softmax CE in
f32, batched over images: each function reduces one image's entries as
the JAX package does and returns one value per image; the train step
takes their mean over the batch."""

from __future__ import annotations

import torch


def smooth_l1(bbox_pred, bbox_targets, inside_w, outside_w, sigma: float,
              reduce_dims) -> torch.Tensor:
    """Elementwise Huber with a 1/sigma^2 knee, inside/outside weighted,
    summed over reduce_dims (per image), then the mean over what is left
    but the leading batch dim: (B,)."""
    s2 = sigma * sigma
    diff = inside_w * (bbox_pred - bbox_targets)
    ad = diff.abs()
    flag = (ad < 1.0 / s2).to(torch.float32)
    per = flag * 0.5 * s2 * diff * diff + (1.0 - flag) * (ad - 0.5 / s2)
    per = (outside_w * per).sum(dim=reduce_dims)
    return per.reshape(per.shape[0], -1).mean(dim=1)


def masked_softmax_ce(logits, labels, valid) -> torch.Tensor:
    """Mean CE over the entries with valid True, per image: logits
    (B, N, C), labels (B, N), valid (B, N) -> (B,).  In f32: a bf16
    logsumexp can round below the max logit on confident rows."""
    logits = logits.to(torch.float32)
    label_logits = torch.gather(
        logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - label_logits
    n = torch.clamp(valid.sum(dim=-1), min=1).to(torch.float32)
    return torch.where(valid, ce, 0.0).sum(dim=-1) / n


def detection_losses(rpn_cls_logits, rpn_labels, rpn_bbox_pred, rpn_targets,
                     rpn_in_w, rpn_out_w, cls_score, labels, bbox_pred,
                     bbox_targets, bbox_in_w, bbox_out_w) -> dict:
    """The 4-term loss per image: rpn_cls_logits (B, K, 2) per-anchor (neg,
    pos) logits; rpn_labels (B, K) in {-1, 0, 1}; cls_score (B, S, C);
    labels (B, S).  Each value is (B,)."""
    rpn_ce = masked_softmax_ce(rpn_cls_logits, rpn_labels.to(torch.int32),
                               rpn_labels >= 0)
    # the reference sums over every element of an image's (K, 4) deltas
    rpn_box = smooth_l1(rpn_bbox_pred, rpn_targets, rpn_in_w, rpn_out_w,
                        sigma=3.0, reduce_dims=(1, 2))
    ce = masked_softmax_ce(cls_score, labels,
                           torch.ones(labels.shape, dtype=torch.bool,
                                      device=labels.device))
    box = smooth_l1(bbox_pred, bbox_targets, bbox_in_w, bbox_out_w,
                    sigma=1.0, reduce_dims=(2,))
    total = ce + box + rpn_ce + rpn_box
    return {'rpn_cross_entropy': rpn_ce, 'rpn_loss_box': rpn_box,
            'cross_entropy': ce, 'loss_box': box, 'total_loss': total}
