"""Box geometry (counterpart of `tpudenoise/ops/boxes.py`): decode, clip,
encode (`bbox_transform`) and IoU (`bbox_overlaps`), with the
reference's "+1 pixel" width convention.  Boxes are (..., 4) in
(x1, y1, x2, y2); everything broadcasts over leading dims."""

from __future__ import annotations

import torch


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor
                       ) -> torch.Tensor:
    """Decode (..., N, 4K) deltas on (..., N, 4) boxes."""
    boxes = boxes.to(deltas.dtype)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx, dy = deltas[..., 0::4], deltas[..., 1::4]
    dw, dh = deltas[..., 2::4], deltas[..., 3::4]
    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                       pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                      dim=-1)
    return out.reshape(deltas.shape)


def _hw(im_shape, ref: torch.Tensor):
    """(H, W) as scalars, or tensors of ref's leading shape broadcast
    against ref's (..., N, K) coordinate slices."""
    h, w = im_shape
    if isinstance(h, torch.Tensor):
        pad = (1,) * (ref.dim() - h.dim())
        h, w = h.reshape(h.shape + pad), w.reshape(w.shape + pad)
    return h, w


def clip_boxes(boxes: torch.Tensor, im_shape) -> torch.Tensor:
    """Clip (..., N, 4K) boxes to [0, W-1] x [0, H-1]; im_shape = (H, W),
    scalars or tensors of the leading shape."""
    h, w = _hw(im_shape, boxes)
    lo = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x = torch.minimum(torch.maximum(boxes[..., 0::4], lo), w - 1)
    y = torch.minimum(torch.maximum(boxes[..., 1::4], lo), h - 1)
    x2 = torch.minimum(torch.maximum(boxes[..., 2::4], lo), w - 1)
    y2 = torch.minimum(torch.maximum(boxes[..., 3::4], lo), h - 1)
    return torch.stack([x, y, x2, y2], dim=-1).reshape(boxes.shape)


def clip_boxes_lower_only(boxes: torch.Tensor, im_shape) -> torch.Tensor:
    """Test-path clip of im_detect: x1/y1 floored at 0, x2/y2 capped at
    W-1/H-1, and nothing else (a preserved reference quirk)."""
    h, w = _hw(im_shape, boxes)
    lo = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x = torch.maximum(boxes[..., 0::4], lo)
    y = torch.maximum(boxes[..., 1::4], lo)
    x2 = torch.minimum(boxes[..., 2::4], w - 1)
    y2 = torch.minimum(boxes[..., 3::4], h - 1)
    return torch.stack([x, y, x2, y2], dim=-1).reshape(boxes.shape)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor
                   ) -> torch.Tensor:
    """Encode (..., 4) gt boxes relative to (..., 4) example boxes:
    (..., 4) deltas (dx, dy, dw, dh)."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h
    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)],
                       dim=-1)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor
                  ) -> torch.Tensor:
    """IoU of (..., N, 4) boxes against (..., K, 4) query boxes ->
    (..., N, K), 0 where the union is not positive."""
    bx = boxes[..., :, None, :]
    qx = query_boxes[..., None, :, :]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    iw = torch.maximum(torch.minimum(bx[..., 2], qx[..., 2])
                       - torch.maximum(bx[..., 0], qx[..., 0]) + 1.0, zero)
    ih = torch.maximum(torch.minimum(bx[..., 3], qx[..., 3])
                       - torch.maximum(bx[..., 1], qx[..., 1]) + 1.0, zero)
    inter = iw * ih
    area_b = ((bx[..., 2] - bx[..., 0] + 1.0)
              * (bx[..., 3] - bx[..., 1] + 1.0))
    area_q = ((qx[..., 2] - qx[..., 0] + 1.0)
              * (qx[..., 3] - qx[..., 1] + 1.0))
    union = area_b + area_q - inter
    return torch.where(union > 0, inter / union, zero)
