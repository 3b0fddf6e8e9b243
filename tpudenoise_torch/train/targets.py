"""Training target assignment on the device, batched over images
(counterpart of `tpudenoise/train/targets.py`).

`anchor_target_layer` labels the RPN's anchors (fg, bg, ignore) and
encodes their regression targets; `proposal_target_layer` samples the
RoI head's batch of proposals with class labels and class-expanded
targets.  Both take one key per image ((B, 2) uint32, the host keys of
`core.prng`) and reproduce jax.random's draws on the same key: the
uniform fields through `prng.draw_uniform` (the threefry kernel on a
GPU), the iid resampling through `randint` below, whose bound is a count
on the device.  Sorts are stable, as `jnp.argsort`, so the BIG-filled
entries and equal draws tie in index order.  Nothing here waits on the
host: the counts stay device tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.ops.boxes import bbox_overlaps, bbox_transform

BIG = float(np.float32(1e9))
_M32 = 0xFFFFFFFF


class AnchorTargets(NamedTuple):
    labels: torch.Tensor                # (B, K) float: 1 fg, 0 bg, -1 ignore
    bbox_targets: torch.Tensor          # (B, K, 4)
    bbox_inside_weights: torch.Tensor   # (B, K, 1)
    bbox_outside_weights: torch.Tensor  # (B, K, 1)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor                  # (B, S, 4)
    labels: torch.Tensor                # (B, S) int32
    bbox_targets: torch.Tensor          # (B, S, 4 * num_classes)
    bbox_inside_weights: torch.Tensor
    bbox_outside_weights: torch.Tensor


def randint(keys, n: int, maxval: torch.Tensor) -> torch.Tensor:
    """`jax.random.randint(key, (n,), 0, maxval)` for each key of (B, 2),
    with maxval a (B,) int tensor on the device (in int32 range): the two
    32-bit fields of split(key) from the threefry draw, reduced modulo the
    span with jax's multiplier trick.  Returns (B, n) int64."""
    dev = maxval.device
    ks = prng.split(keys)                                   # (B, 2, 2)
    hi = prng.draw_bits(ks[:, 0], n, dev).to(torch.int64) & _M32
    lo = prng.draw_bits(ks[:, 1], n, dev).to(torch.int64) & _M32
    span = torch.where(maxval > 0, maxval.to(torch.int64), 1)[:, None]
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span       # uint32 products wrap
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return off % span


def _first_n(keys, mask: torch.Tensor, keep_n: torch.Tensor
             ) -> torch.Tensor:
    """Per row, a random subset of keep_n of the True entries of mask
    (B, K): the entries whose rank in the stable sort of uniform draws
    (BIG where mask is False) is below keep_n (B,)."""
    b, k = mask.shape
    r = prng.draw_uniform(keys, k, mask.device)
    order = torch.argsort(torch.where(mask, r, BIG), dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(k, device=mask.device).expand(b, k))
    return mask & (rank < keep_n[:, None])


def _gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """boxes (B, N, 4), idx (B, M) -> (B, M, 4)."""
    return torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))


def anchor_target_layer(keys, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_mask: torch.Tensor, im_hw: torch.Tensor,
                        rpn_batch: int = 256, fg_fraction: float = 0.5,
                        pos_thresh: float = 0.7, neg_thresh: float = 0.3,
                        clobber_positives: bool = False) -> AnchorTargets:
    """RPN labels and targets.  keys (B, 2) uint32; anchors (K, 4);
    gt_boxes (B, G, 5) padded; gt_mask (B, G); im_hw (B, 2) true (h, w)."""
    keys = prng.key_data(keys).reshape(-1, 2)
    b, k = gt_boxes.shape[0], anchors.shape[0]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < im_hw[:, 1:2])
              & (anchors[None, :, 3] < im_hw[:, 0:1]))          # (B, K)
    overlaps = bbox_overlaps(anchors.expand(b, k, 4), gt_boxes[..., :4])
    overlaps = torch.where(gt_mask[:, None, :] & inside[..., None],
                           overlaps, -1.0)
    # torch.argmax keeps the first of equal maxima, as jnp.argmax
    max_ov, argmax = overlaps.amax(dim=2), torch.argmax(overlaps, dim=2)
    gt_max = overlaps.amax(dim=1)                               # (B, G)
    is_gt_best = ((overlaps == gt_max[:, None, :]) & gt_mask[:, None, :]
                  & (gt_max[:, None, :] > 0)).any(dim=2)

    neg = inside & (max_ov < neg_thresh) & (max_ov >= 0)
    labels = torch.full((b, k), -1.0, device=anchors.device)
    if not clobber_positives:
        labels = torch.where(neg, 0.0, labels)
    labels = torch.where(is_gt_best & inside, 1.0, labels)
    labels = torch.where(inside & (max_ov >= pos_thresh), 1.0, labels)
    if clobber_positives:
        labels = torch.where(neg, 0.0, labels)

    k1, k2 = np.moveaxis(prng.split(keys), 1, 0)
    fg = labels == 1.0
    cap = torch.full((b,), int(fg_fraction * rpn_batch),
                     device=anchors.device)
    labels = torch.where(fg & ~_first_n(k1, fg, cap), -1.0, labels)
    num_fg = (labels == 1.0).sum(dim=1)
    bg = labels == 0.0
    labels = torch.where(bg & ~_first_n(k2, bg, rpn_batch - num_fg), -1.0,
                         labels)

    targets = bbox_transform(anchors.expand(b, k, 4),
                             _gather_boxes(gt_boxes[..., :4], argmax))
    targets = torch.where(inside[..., None], targets, 0.0)
    # (B, K, 1) weights, broadcast over the 4 coordinates
    in_w = (labels == 1.0).to(torch.float32)[..., None]
    num_examples = torch.clamp((labels >= 0).sum(dim=1), min=1).to(
        torch.float32)
    out_w = torch.where(labels >= 0, (1.0 / num_examples)[:, None],
                        0.0)[..., None]
    return AnchorTargets(labels, targets, in_w, out_w)


def proposal_target_layer(keys, rois: torch.Tensor, roi_mask: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                          num_classes: int, batch: int = 128,
                          fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                          bg_hi: float = 0.5, bg_lo: float = 0.1,
                          bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
                          bbox_normalize_means=(0., 0., 0., 0.),
                          use_gt: bool = False) -> ProposalTargets:
    """Sample `batch` RoIs per image with labels and class-expanded
    targets.  keys (B, 2) uint32; rois (B, R, 4) image-space proposals
    with roi_mask (B, R); gt_boxes (B, G, 5) padded.

    The returned rois are detached: no gradient flows from the RoI head's
    losses back into the RPN through the sampled rois or the targets (the
    reference computes this layer on the host)."""
    keys = prng.key_data(keys).reshape(-1, 2)
    rois = rois.detach()
    if use_gt:
        rois = torch.cat([rois, gt_boxes[..., :4]], dim=1)
        roi_mask = torch.cat([roi_mask, gt_mask], dim=1)
    b, r = rois.shape[:2]
    dev = rois.device
    overlaps = bbox_overlaps(rois, gt_boxes[..., :4])           # (B, R, G)
    overlaps = torch.where(gt_mask[:, None, :] & roi_mask[..., None],
                           overlaps, -1.0)
    max_ov, gt_assign = overlaps.amax(dim=2), torch.argmax(overlaps, dim=2)
    roi_labels = torch.gather(gt_boxes[..., 4], 1, gt_assign)

    is_fg = roi_mask & (max_ov >= fg_thresh)
    is_bg = roi_mask & (max_ov < bg_hi) & (max_ov >= bg_lo)
    n_fg, n_bg = is_fg.sum(dim=1), is_bg.sum(dim=1)             # (B,)

    k1, k2, k3, k4 = np.moveaxis(prng.split(keys, 4), 1, 0)
    fg_order = torch.argsort(torch.where(
        is_fg, prng.draw_uniform(k1, r, dev), BIG), dim=-1, stable=True)
    bg_order = torch.argsort(torch.where(
        is_bg, prng.draw_uniform(k2, r, dev), BIG), dim=-1, stable=True)

    # the fg count per the reference's three regimes
    fg_cap = int(fg_fraction * batch)
    fg_count = torch.where((n_fg > 0) & (n_bg > 0),
                           torch.clamp(n_fg, max=fg_cap),
                           torch.where(n_fg > 0, batch, 0))[:, None]
    slots = torch.arange(batch, device=dev)[None]
    # fg slot i: without replacement while i < n_fg, else iid resampled
    fg_idx = torch.where(slots < n_fg[:, None], slots,
                         randint(k3, batch, torch.clamp(n_fg, min=1)))
    fg_sel = torch.gather(fg_order, 1, torch.clamp(fg_idx, max=r - 1))
    bg_j = slots - fg_count
    bg_idx = torch.where(bg_j < n_bg[:, None], bg_j,
                         randint(k4, batch, torch.clamp(n_bg, min=1)))
    bg_sel = torch.gather(bg_order, 1, torch.clamp(bg_idx, 0, r - 1))
    take_fg = slots < fg_count
    sel = torch.where(take_fg, fg_sel, bg_sel)
    # an image with neither fg nor bg: the first valid roi, label 0
    none_valid = ((n_fg == 0) & (n_bg == 0))[:, None]
    fallback = torch.argmax(roi_mask.to(torch.int32), dim=1)[:, None]
    sel = torch.where(none_valid, fallback, sel)

    out_rois = _gather_boxes(rois, sel)
    labels = torch.where(take_fg & ~none_valid,
                         torch.gather(roi_labels, 1, sel), 0.0).to(
        torch.int32)
    targets = bbox_transform(out_rois, _gather_boxes(
        gt_boxes[..., :4], torch.gather(gt_assign, 1, sel)))
    # per column with the constants as f32 scalars: no host copy
    targets = torch.stack([(targets[..., i] - float(np.float32(m)))
                           / float(np.float32(s)) for i, (m, s) in
                           enumerate(zip(bbox_normalize_means,
                                         bbox_normalize_stds))], dim=-1)

    # the 4K layout: the targets in the label's class slice, fg only
    fg_slot = (torch.nn.functional.one_hot(
        torch.clamp(labels, 0, num_classes - 1).long(), num_classes).bool()
        & (labels > 0)[..., None])[..., None]                  # (B,S,C,1)
    bt = torch.where(fg_slot, targets[:, :, None, :], 0.0).reshape(
        b, batch, num_classes * 4)
    iw = fg_slot.expand(b, batch, num_classes, 4).to(torch.float32).reshape(
        b, batch, num_classes * 4)
    return ProposalTargets(out_rois, labels, bt, iw, iw.clone())
