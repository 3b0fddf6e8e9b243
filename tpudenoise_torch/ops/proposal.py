"""RPN proposals, batched over images (counterpart of
`tpudenoise/ops/proposal.py`): decode the deltas on every anchor, clip,
mask anchors centred in the bucket padding, take the pre-NMS top-K and
run the packed NMS.

Top-K ties: `lax.top_k` keeps the lower index first; `torch.topk` on the
card promises no order among equal scores, and bf16 RPN logits tie often.
So the top-K is a stable descending sort, sliced.
"""

from __future__ import annotations

import torch

from tpudenoise_torch.ops.boxes import bbox_transform_inv, clip_boxes
from tpudenoise_torch.ops.nms import NEG_INF, nms_packed


def _top_k(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _inside(anchors: torch.Tensor, im_hw: torch.Tensor) -> torch.Tensor:
    """(B, K) mask of anchors centred inside each image's true extent."""
    cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    return (cx[None] < im_hw[:, 1:2]) & (cy[None] < im_hw[:, 0:1])


def proposal_layer(rpn_scores: torch.Tensor, rpn_deltas: torch.Tensor,
                   anchors: torch.Tensor, im_hw: torch.Tensor,
                   nms_thresh: float, pre_nms_top_n: int,
                   post_nms_top_n: int):
    """rpn_scores (B, K), rpn_deltas (B, K, 4), anchors (K, 4), im_hw
    (B, 2) true (h, w).  Returns rois (B, post, 4), scores (B, post) and
    mask (B, post)."""
    proposals = clip_boxes(bbox_transform_inv(anchors, rpn_deltas),
                           (im_hw[:, 0], im_hw[:, 1]))
    scores = torch.where(_inside(anchors, im_hw), rpn_scores, NEG_INF)
    top_scores, top_idx = _top_k(scores, min(pre_nms_top_n,
                                             scores.shape[-1]))
    top_boxes = torch.gather(proposals, 1,
                             top_idx[..., None].expand(*top_idx.shape, 4))
    keep, keep_mask = nms_packed(top_boxes, top_scores, nms_thresh,
                                 post_nms_top_n,
                                 valid=top_scores > NEG_INF, presorted=True)
    safe = keep.clamp(min=0).to(torch.int64)
    rois = torch.where(keep_mask[..., None], torch.gather(
        top_boxes, 1, safe[..., None].expand(*safe.shape, 4)), 0.0)
    roi_scores = torch.where(keep_mask, torch.gather(top_scores, 1, safe),
                             0.0)
    return rois, roi_scores, keep_mask


def proposal_top_layer(rpn_scores: torch.Tensor, rpn_deltas: torch.Tensor,
                       anchors: torch.Tensor, im_hw: torch.Tensor,
                       top_n: int):
    """NMS-free alternative: top `top_n` by score, then decode + clip."""
    scores = torch.where(_inside(anchors, im_hw), rpn_scores, NEG_INF)
    top_scores, top_idx = _top_k(scores, top_n)
    props = bbox_transform_inv(
        anchors[top_idx],
        torch.gather(rpn_deltas, 1,
                     top_idx[..., None].expand(*top_idx.shape, 4)))
    props = clip_boxes(props, (im_hw[:, 0], im_hw[:, 1]))
    mask = top_scores > NEG_INF
    return props, torch.where(mask, top_scores, 0.0), mask
