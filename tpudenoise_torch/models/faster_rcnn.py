"""Faster R-CNN, batched (counterpart of `tpudenoise/models/faster_rcnn.py`):
backbone -> RPN -> proposals (packed NMS kernel) -> crop_and_resize (+
max-pool) -> tail -> heads.  `forward_test` is inference;
`forward_train` adds the target layers (`train/targets.py`), dropout in
the vgg16 tail and the four losses (`train/losses.py`).

Images arrive NHWC (B, H, W, 3) f32, BGR, mean-subtracted and padded to a
bucket, with the true extent in im_info (B, 3) = (h, w, scale).  Inside,
the convs run NCHW in channels-last memory; the RoI stage works on NHWC
features so that the fc6 flatten keeps the JAX package's HWC order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import AttrDict, default_config
from tpudenoise_torch.models.backbones import mobilenet, resnet, vgg
from tpudenoise_torch.models.rpn import RCNNHead, RPNHead, rpn_softmax_scores
from tpudenoise_torch.ops.anchors import anchor_grid, num_anchors
from tpudenoise_torch.ops.proposal import proposal_layer, proposal_top_layer
from tpudenoise_torch.ops.roi_align import (crop_and_resize,
                                            max_pool_2x2_same,
                                            roi_boxes_to_normalized)
from tpudenoise_torch.train.losses import detection_losses
from tpudenoise_torch.train.targets import (anchor_target_layer,
                                            proposal_target_layer)

FEAT_STRIDE = 16


class _Losses(nn.Module):
    """`FasterRCNN._losses` as a module's forward, for
    `torch.func.functional_call`, which calls only a module's forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.m = model

    def forward(self, *args):
        return self.m._losses(*args)


class FasterRCNN(nn.Module):
    """backbone: 'vgg16', 'res50', 'res101', 'res152' or 'mobile'."""

    def __init__(self, backbone: str = 'res101', num_classes: int = 21,
                 anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                 cfg: AttrDict | None = None, dtype=torch.bfloat16):
        super().__init__()
        if backbone not in ('vgg16', 'res50', 'res101', 'res152', 'mobile'):
            raise ValueError(f'unknown backbone {backbone!r}')
        self.backbone = backbone
        self.num_classes = num_classes
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.cfg = cfg or default_config()
        self.dtype = dtype
        self.num_anchors = num_anchors(self.anchor_scales,
                                       self.anchor_ratios)
        self.pool_size = self.cfg.POOLING_SIZE
        if backbone == 'vgg16':
            head, tail = vgg.VGG16Head(dtype), vgg.VGG16Tail(
                self.pool_size, 512, dtype)
            feat_c, fc_c = 512, 4096
            self.pool_then_max = True       # crop 14 -> max-pool 7
            self.frozen_filter = vgg.frozen_param_filter()
        elif backbone == 'mobile':
            dm = self.cfg.MOBILENET.DEPTH_MULTIPLIER
            head = mobilenet.MobileNetV1Head(dm, dtype)
            tail = mobilenet.MobileNetV1Tail(dm, dtype)
            feat_c, fc_c = head.out_channels, tail.out_channels
            self.pool_then_max = True       # crop 14 -> max-pool 7
            self.frozen_filter = mobilenet.frozen_param_filter(
                self.cfg.MOBILENET.FIXED_LAYERS)
        else:
            n = int(backbone[3:])
            head, tail = resnet.ResNetHead(n, dtype), resnet.ResNetTail(
                n, dtype)
            feat_c, fc_c = 1024, 2048
            # RESNET.MAX_POOL False: a direct 7x7 crop
            self.pool_then_max = bool(self.cfg.RESNET.MAX_POOL)
            self.frozen_filter = resnet.frozen_param_filter(
                self.cfg.RESNET.FIXED_BLOCKS,
                freeze_root=bool(self.cfg.RESNET.get('FREEZE_ROOT', True)))
        self.head = head
        self.rpn = RPNHead(self.num_anchors, self.cfg.RPN_CHANNELS, feat_c,
                           dtype)
        self.tail = tail
        # the reference builds its cls/bbox heads without passing the model
        # dtype (faster_rcnn.py:51), so they compute in bf16 even in an f32
        # model; kept, for parity
        self.rcnn = RCNNHead(num_classes, fc_c)

    def init(self, generator: torch.Generator, image_shape=(608, 1024)):
        """Seeded random init of every parameter (image_shape is accepted
        for parity with the JAX `init`; the shapes do not depend on it):
        flax's lecun-normal conv and dense kernels, zero biases, identity
        BN (every resnet conv3 zeroed), and the RPN and class heads'
        normals, drawn from `generator` in the order head, rpn, tail,
        rcnn.  Returns the parameters as a state dict."""
        for m in (self.head, self.rpn, self.tail, self.rcnn):
            m.reset_parameters(generator)
        return self.state_dict()

    def frozen(self, name: str) -> bool:
        """Whether the trainable parameter `name` (a state-dict key) stays
        fixed in training: the backbone's boundaries, in the head only."""
        top, *path = name.split('.')
        return top == 'head' and self.frozen_filter(path)

    def _rpn(self, images: torch.Tensor):
        """feat (B, C, fh, fw), RPN logits (B, fh, fw, 2A), scores (B, K),
        deltas (B, K, 4) and anchors (K, 4)."""
        b = images.shape[0]
        feat = self.head(images.permute(0, 3, 1, 2))            # NCHW
        rpn_cls, rpn_bbox = self.rpn(feat)
        fh, fw = feat.shape[2], feat.shape[3]
        scores = rpn_softmax_scores(rpn_cls, self.num_anchors)
        deltas = rpn_bbox.reshape(b, -1, 4)
        anchors = anchor_grid(fh, fw, FEAT_STRIDE, self.anchor_scales,
                              self.anchor_ratios, device=images.device)
        return feat, rpn_cls, scores, deltas, anchors

    def _pool(self, feat: torch.Tensor, rois: torch.Tensor,
              dropout_keys=None):
        """RoI pooling, tail and heads over (B, R, 4) image-space rois:
        cls_score and bbox_pred (B * R, .)."""
        b = feat.shape[0]
        fh, fw = feat.shape[2], feat.shape[3]
        feat_nhwc = feat.permute(0, 2, 3, 1)
        norm = roi_boxes_to_normalized(rois, (fh, fw), FEAT_STRIDE)
        if self.pool_then_max:
            crops = max_pool_2x2_same(
                crop_and_resize(feat_nhwc, norm, self.pool_size * 2))
        else:
            crops = crop_and_resize(feat_nhwc, norm, self.pool_size)
        crops = crops.reshape(b * rois.shape[1], *crops.shape[2:])
        if dropout_keys is None:
            return self.rcnn(self.tail(crops))
        return self.rcnn(self.tail(crops, dropout_keys))

    def forward(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        """Inference."""
        C = self.cfg
        b = images.shape[0]
        feat, _, scores, deltas, anchors = self._rpn(images)
        im_hw = im_info[:, :2].to(torch.float32)
        if C.TEST.MODE == 'top':
            rois, roi_scores, mask = proposal_top_layer(
                scores, deltas, anchors, im_hw, C.TEST.RPN_TOP_N)
        else:
            rois, roi_scores, mask = proposal_layer(
                scores, deltas, anchors, im_hw, C.TEST.RPN_NMS_THRESH,
                C.TEST.RPN_PRE_NMS_TOP_N, C.TEST.RPN_POST_NMS_TOP_N)
        r = rois.shape[1]
        cls_score, bbox_pred = self._pool(feat, rois)
        cls_score = cls_score.reshape(b, r, -1)
        stds = torch.tensor(C.TRAIN.BBOX_NORMALIZE_STDS, dtype=torch.float32,
                            device=images.device).repeat(self.num_classes)
        means = torch.tensor(C.TRAIN.BBOX_NORMALIZE_MEANS,
                             dtype=torch.float32,
                             device=images.device).repeat(self.num_classes)
        bbox_pred = bbox_pred.reshape(b, r, -1) * stds + means
        return {'rois': rois, 'roi_scores': roi_scores, 'roi_mask': mask,
                'cls_score': cls_score,
                'cls_prob': torch.softmax(cls_score, dim=-1),
                'bbox_pred': bbox_pred,
                # the mean of the padded feature map in the feature dtype,
                # as f32 (jnp.mean of bf16 sums in f32 and rounds)
                'feat_pooled': feat.float().mean(dim=(2, 3)).to(
                    feat.dtype).float()}

    def _losses(self, images, im_info, k_at, k_pt, k_do, gt_boxes, gt_mask):
        """The per-batch mean of the training losses (`forward_train`)."""
        T = self.cfg.TRAIN
        b = images.shape[0]
        feat, rpn_cls, scores, deltas, anchors = self._rpn(images)
        im_hw = im_info[:, :2].to(torch.float32)
        # no gradient crosses the proposals: the target layer detaches
        # its sampled rois, and nothing else reads them
        with torch.no_grad():
            rois, _, mask = proposal_layer(
                scores, deltas, anchors, im_hw, T.RPN_NMS_THRESH,
                T.RPN_PRE_NMS_TOP_N, T.RPN_POST_NMS_TOP_N)
            at = anchor_target_layer(
                k_at, anchors, gt_boxes, gt_mask, im_hw,
                rpn_batch=T.RPN_BATCHSIZE, fg_fraction=T.RPN_FG_FRACTION,
                pos_thresh=T.RPN_POSITIVE_OVERLAP,
                neg_thresh=T.RPN_NEGATIVE_OVERLAP,
                clobber_positives=bool(T.RPN_CLOBBER_POSITIVES))
            pt = proposal_target_layer(
                k_pt, rois, mask, gt_boxes, gt_mask, self.num_classes,
                batch=T.BATCH_SIZE, fg_fraction=T.FG_FRACTION,
                fg_thresh=T.FG_THRESH, bg_hi=T.BG_THRESH_HI,
                bg_lo=T.BG_THRESH_LO,
                bbox_normalize_stds=tuple(T.BBOX_NORMALIZE_STDS),
                bbox_normalize_means=tuple(T.BBOX_NORMALIZE_MEANS),
                use_gt=bool(T.USE_GT))
        cls_score, bbox_pred = self._pool(
            feat, pt.rois, k_do if self.backbone == 'vgg16' else None)
        s = pt.rois.shape[1]
        # the per-anchor (neg, pos) logit pairs in anchor-grid order
        a = self.num_anchors
        rpn_logits = torch.stack([rpn_cls[..., :a].reshape(b, -1),
                                  rpn_cls[..., a:].reshape(b, -1)], dim=-1)
        losses = detection_losses(
            rpn_logits, at.labels, deltas, at.bbox_targets,
            at.bbox_inside_weights, at.bbox_outside_weights,
            cls_score.reshape(b, s, -1), pt.labels,
            bbox_pred.reshape(b, s, -1), pt.bbox_targets,
            pt.bbox_inside_weights, pt.bbox_outside_weights)
        return {k: v.mean() for k, v in losses.items()}

    def forward_train(self, params, key, images: torch.Tensor,
                      im_info: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_mask: torch.Tensor, image_keys=None) -> dict:
        """The training forward with `params` (a state dict whose trainable
        tensors may require grad) over a batch: images (B, H, W, 3)
        preprocessed, im_info (B, 3), gt_boxes (B, G, 5) padded (x1, y1,
        x2, y2, class), gt_mask (B, G).  Image i takes key i of
        split(key, B) (or row i of image_keys, (B, 2): a rank's rows of
        the global batch's split) and splits it into its anchor-target,
        proposal-target and dropout keys, as the JAX step's vmap does.
        Returns the four losses and total_loss, each the mean over the
        batch (no weight decay: the train step adds it)."""
        keys = (prng.split(key, images.shape[0]) if image_keys is None
                else np.asarray(image_keys, np.uint32))         # (B, 2)
        k_at, k_pt, k_do = np.moveaxis(prng.split(keys, 3), 1, 0)
        return torch.func.functional_call(
            _Losses(self), {'m.' + k: v for k, v in params.items()},
            (images, im_info, k_at, k_pt, k_do, gt_boxes, gt_mask))

    @torch.no_grad()
    def forward_test(self, params, images: torch.Tensor,
                     im_info: torch.Tensor) -> dict:
        """Batched inference with `params`, a state dict from `init` or
        `convert.from_jax_params`."""
        return torch.func.functional_call(self, params, (images, im_info))
