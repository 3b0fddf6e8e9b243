"""Faster R-CNN test-time forward, batched (counterpart of
`tpudenoise/models/faster_rcnn.py`): backbone -> RPN -> proposals (packed
NMS kernel) -> crop_and_resize (+ max-pool) -> tail -> heads.

Images arrive NHWC (B, H, W, 3) f32, BGR, mean-subtracted and padded to a
bucket, with the true extent in im_info (B, 3) = (h, w, scale).  Inside,
the convs run NCHW in channels-last memory; the RoI stage works on NHWC
features so that the fc6 flatten keeps the JAX package's HWC order.
"""

from __future__ import annotations

import torch
from torch import nn

from tpudenoise_torch.core.config import AttrDict, default_config
from tpudenoise_torch.models.backbones import resnet, vgg
from tpudenoise_torch.models.rpn import RCNNHead, RPNHead, rpn_softmax_scores
from tpudenoise_torch.ops.anchors import anchor_grid, num_anchors
from tpudenoise_torch.ops.proposal import proposal_layer, proposal_top_layer
from tpudenoise_torch.ops.roi_align import (crop_and_resize,
                                            max_pool_2x2_same,
                                            roi_boxes_to_normalized)

FEAT_STRIDE = 16


class FasterRCNN(nn.Module):
    """backbone: 'vgg16', 'res50', 'res101' or 'res152' ('mobile' is
    still to be ported)."""

    def __init__(self, backbone: str = 'res101', num_classes: int = 21,
                 anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                 cfg: AttrDict | None = None, dtype=torch.bfloat16):
        super().__init__()
        if backbone == 'mobile':
            raise NotImplementedError(
                'backbone mobile: backbones/mobilenet.py is not ported yet '
                '(ROADMAP Queue 1 item 15)')
        if backbone not in ('vgg16', 'res50', 'res101', 'res152'):
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
        else:
            n = int(backbone[3:])
            head, tail = resnet.ResNetHead(n, dtype), resnet.ResNetTail(
                n, dtype)
            feat_c, fc_c = 1024, 2048
            # RESNET.MAX_POOL False: a direct 7x7 crop
            self.pool_then_max = bool(self.cfg.RESNET.MAX_POOL)
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
        for parity with the JAX `init`; the shapes do not depend on it).
        Returns the parameters as a state dict."""
        for m in (self.head, self.rpn, self.tail, self.rcnn):
            m.reset_parameters(generator)
        return self.state_dict()

    def forward(self, images: torch.Tensor, im_info: torch.Tensor) -> dict:
        C = self.cfg
        b = images.shape[0]
        feat = self.head(images.permute(0, 3, 1, 2))            # NCHW
        rpn_cls, rpn_bbox = self.rpn(feat)
        fh, fw = feat.shape[2], feat.shape[3]
        scores = rpn_softmax_scores(rpn_cls, self.num_anchors)
        deltas = rpn_bbox.reshape(b, -1, 4)
        anchors = anchor_grid(fh, fw, FEAT_STRIDE, self.anchor_scales,
                              self.anchor_ratios, device=images.device)
        im_hw = im_info[:, :2].to(torch.float32)
        if C.TEST.MODE == 'top':
            rois, roi_scores, mask = proposal_top_layer(
                scores, deltas, anchors, im_hw, C.TEST.RPN_TOP_N)
        else:
            rois, roi_scores, mask = proposal_layer(
                scores, deltas, anchors, im_hw, C.TEST.RPN_NMS_THRESH,
                C.TEST.RPN_PRE_NMS_TOP_N, C.TEST.RPN_POST_NMS_TOP_N)
        feat_nhwc = feat.permute(0, 2, 3, 1)
        norm = roi_boxes_to_normalized(rois, (fh, fw), FEAT_STRIDE)
        if self.pool_then_max:
            crops = max_pool_2x2_same(
                crop_and_resize(feat_nhwc, norm, self.pool_size * 2))
        else:
            crops = crop_and_resize(feat_nhwc, norm, self.pool_size)
        r = rois.shape[1]
        cls_score, bbox_pred = self.rcnn(self.tail(crops.reshape(
            b * r, *crops.shape[2:])))
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

    @torch.no_grad()
    def forward_test(self, params, images: torch.Tensor,
                     im_info: torch.Tensor) -> dict:
        """Batched inference with `params`, a state dict from `init` or
        `convert.from_jax_params`."""
        return torch.func.functional_call(self, params, (images, im_info))
