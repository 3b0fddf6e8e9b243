"""Faster R-CNN test forward in plain PyTorch over a state dict, as
tf-faster-rcnn describes it (`lib/nets/resnet_v1.py`, `vgg16.py`,
`network.py`; `lib/layer_utils/proposal_layer.py`), float32, one chunk
of images at a time.

* prep: mean subtraction and cv2's bilinear resize (INTER_LINEAR:
  src = (dst + 0.5) / scale - 0.5, two taps) into the zero-padded bucket;
* res101: 7x7/2 conv, BN, ReLU, 3x3/2 max-pool, blocks 1-3 (bottleneck
  units, the stride on each block's last unit, a 1x1 conv + BN shortcut
  where the depth changes), block4 on 7x7 crops and the mean over H and
  W as the tail; vgg16: 13 3x3 convs with 2x2 max-pools after stages
  1-4, 14x14 crops max-pooled to 7x7, fc6 and fc7 as the tail;
* the RPN: 3x3 conv + ReLU, 1x1 objectness and box convs; anchors of
  the configuration's scales and ratios on the stride-16 grid; decode,
  clip, drop anchors centred outside the image, the top
  RPN_PRE_NMS_TOP_N by score, greedy NMS at RPN_NMS_THRESH, the first
  RPN_POST_NMS_TOP_N kept;
* crops: tf.image.crop_and_resize (bilinear, 0 outside the map) at
  boxes normalised over (feature extent - 1) * 16;
* heads: class logits and box deltas, un-normalised by the training
  stds and means.

State-dict keys are the program's: the benchmark makes one dict of
weights and hands it to both.  Frozen BN: x * gamma / sqrt(var + 1e-5)
+ beta - mean * gamma / sqrt(var + 1e-5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.arith import Arith

STRIDE = 16
BLOCKS = {101: ((64, 3, 2), (128, 4, 2), (256, 23, 1), (512, 3, 1))}
VGG_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
BBOX_MEANS = (0.0, 0.0, 0.0, 0.0)
NEG = float(np.finfo(np.float32).min)


# ------------------------------------------------------------- prep --

def rescale(h: int, w: int, target: int, max_size: int):
    """(scale, oh, ow): the short side to target unless the long side
    would pass max_size; sizes rounded as cv2's dsize."""
    s = float(target) / float(min(h, w))
    if np.round(s * max(h, w)) > max_size:
        s = float(max_size) / float(max(h, w))
    return s, int(np.round(h * s)), int(np.round(w * s))


def _taps(out_size: int, out_len: int, in_len: int, scale: float, dev):
    y = torch.arange(out_size, dtype=torch.float32, device=dev)
    s = torch.clamp((y + 0.5) * float(np.float32(1.0 / np.float32(scale)))
                    - 0.5, min=0.0).clamp(max=in_len - 1.0)
    i0 = torch.clamp(torch.floor(s), min=0.0).clamp(max=max(in_len - 2, 0))
    return i0.long(), s - i0, y < out_len


def prep(frames: torch.Tensor, means, target: int, max_size: int, bucket,
         A: Arith):
    """(B, H, W, 3) float32 BGR -> ((B, PH, PW, 3) prepped, (B, 3)
    im_info rows (oh, ow, scale))."""
    b, h, w, _ = frames.shape
    s, oh, ow = rescale(h, w, target, max_size)
    x = frames - torch.as_tensor(np.asarray(means, np.float32).reshape(3),
                                 device=frames.device)
    ph, pw = bucket
    yi, fy, vy = _taps(ph, oh, h, s, frames.device)
    xi, fx, vx = _taps(pw, ow, w, s, frames.device)
    x, fy, fx = A.resize_operand(x), A.resize_operand(fy), \
        A.resize_operand(fx)
    yi1 = torch.clamp(yi + 1, max=h - 1)
    xi1 = torch.clamp(xi + 1, max=w - 1)
    rows = ((1.0 - fy)[:, None, None] * x[:, yi]
            + fy[:, None, None] * x[:, yi1])
    rows = A.resize_operand(rows)
    out = ((1.0 - fx)[:, None] * rows[:, :, xi]
           + fx[:, None] * rows[:, :, xi1])
    out = out * (vy[:, None, None] & vx[None, :, None])
    info = torch.tensor([[oh, ow, s]] * b, dtype=torch.float32,
                        device=frames.device)
    return out, info


# ---------------------------------------------------------- backbone --

def _bn(sd, p, x):
    root = torch.sqrt(sd[p + '.var'] + 1e-5)
    scale = sd[p + '.gamma'] / root
    bias = sd[p + '.beta'] - sd[p + '.mean'] * scale
    return x * scale[:, None, None] + bias[:, None, None]


def _conv(sd, p, x, A, stride=1, bias=False):
    w = sd[p + '.weight']
    return A.conv(x, w, sd[p + '.bias'] if bias else None, stride,
                  (w.shape[-1] - 1) // 2)


def _unit(sd, p, x, stride, A):
    if p + '.shortcut.weight' in sd:
        sc = _bn(sd, p + '.shortcut_bn', _conv(sd, p + '.shortcut', x, A,
                                               stride))
    else:
        sc = x[:, :, ::stride, ::stride]
    r = F.relu(_bn(sd, p + '.bn1', _conv(sd, p + '.conv1', x, A)))
    r = F.relu(_bn(sd, p + '.bn2', _conv(sd, p + '.conv2', r, A, stride)))
    return F.relu(sc + _bn(sd, p + '.bn3', _conv(sd, p + '.conv3', r, A)))


def _block(sd, p, x, units: int, stride: int, A):
    for i in range(units):
        x = _unit(sd, f'{p}.unit_{i + 1}', x,
                  stride if i == units - 1 else 1, A)
    return x


def head(sd, net: str, x, A):
    """NCHW (B, 3, H, W) prepped images -> (B, C, H/16, W/16)."""
    if net == 'vgg16':
        for si, (reps, _) in enumerate(VGG_STAGES):
            for ri in range(reps):
                x = F.relu(_conv(sd, f'head.conv{si + 1}_{ri + 1}', x, A,
                                 bias=True))
            if si < 4:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x
    x = F.relu(_bn(sd, 'head.conv1_bn', _conv(sd, 'head.conv1', x, A, 2)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for bi, (_, units, stride) in enumerate(BLOCKS[101][:3]):
        x = _block(sd, f'head.block{bi + 1}', x, units, stride, A)
    return x


def tail(sd, net: str, crops, A):
    """(R, S, S, C) NHWC crops -> (R, F) features."""
    if net == 'vgg16':
        x = crops.reshape(crops.shape[0], -1)
        x = F.relu(A.linear(x, sd['tail.fc6.weight'], sd['tail.fc6.bias']))
        return F.relu(A.linear(x, sd['tail.fc7.weight'],
                               sd['tail.fc7.bias']))
    _, units, stride = BLOCKS[101][3]
    x = _block(sd, 'tail.block4', crops.permute(0, 3, 1, 2), units, stride,
               A)
    return x.mean(dim=(2, 3))


# --------------------------------------------------------------- RPN --

def base_anchors(scales, ratios, base: int = 16) -> np.ndarray:
    """The (A, 4) anchors around the (0, 0, 15, 15) window,
    `generate_anchors.py` of the reference."""
    def whctrs(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack((cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)))

    w, h, cx, cy = whctrs(np.array([0, 0, base - 1, base - 1], np.float64))
    ratios = np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    out = []
    for a in mk(ws, np.round(ws * ratios), cx, cy):
        w, h, cx, cy = whctrs(a)
        out.append(mk(w * np.asarray(scales, np.float64),
                      h * np.asarray(scales, np.float64), cx, cy))
    return np.vstack(out)


def anchors(fh: int, fw: int, scales, ratios, dev) -> torch.Tensor:
    """(fh * fw * A, 4): anchors fastest, then x, then y; the shifts
    added in integers, as the reference's int32 path."""
    base = torch.as_tensor(base_anchors(scales, ratios).astype(np.int64),
                           device=dev)
    sy, sx = torch.meshgrid(torch.arange(fh, device=dev) * STRIDE,
                            torch.arange(fw, device=dev) * STRIDE,
                            indexing='ij')
    shift = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return (base[None] + shift).reshape(-1, 4).float()


def decode(boxes, deltas):
    """(N, 4) boxes, (N, 4K) deltas -> (N, 4K) boxes, the +1 widths."""
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx, cy = boxes[:, 0] + 0.5 * w, boxes[:, 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[:, k::4] for k in range(4))
    px, py = dx * w[:, None] + cx[:, None], dy * h[:, None] + cy[:, None]
    pw, ph = torch.exp(dw) * w[:, None], torch.exp(dh) * h[:, None]
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw,
                        py + 0.5 * ph], -1).reshape(deltas.shape)


def iou_matrix(a, b):
    """IoU of (N, 4) against (M, 4), the +1 widths, in the order
    inter / ((area_a + area_b) - inter)."""
    ax1, ay1, ax2, ay2 = (a[:, k, None] for k in range(4))
    bx1, by1, bx2, by2 = (b[None, :, k] for k in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
                     + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
                     + 1.0, min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    return inter / ((area_a + area_b) - inter)


def greedy_nms(boxes, valid, thresh: float, max_out: int) -> list:
    """Greedy NMS over score-sorted (N, 4) boxes: the positions kept, in
    order, at most max_out; box j is dropped when a kept box before it
    overlaps it by more than thresh."""
    sup = (iou_matrix(boxes, boxes) > float(np.float32(thresh))).cpu().numpy()
    removed = ~valid.cpu().numpy()
    keep = []
    for i in range(len(removed)):
        if removed[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        removed[i + 1:] |= sup[i, i + 1:]
    return keep


def rpn(sd, feat, A: Arith):
    """The RPN head over NCHW features: positive-class scores (B, K) and
    box deltas (B, K, 4), K = fh * fw * A in the anchors-fastest order,
    the map's (fh, fw), and the size of the terms each delta sums
    (|W| |x| + |b| of the 1x1 box conv over the 3x3 conv's output x),
    (B, K, 4)."""
    x = F.relu(_conv(sd, 'rpn.rpn_conv', feat, A, bias=True))
    cls = _conv(sd, 'rpn.rpn_cls_score', x, A, bias=True).permute(0, 2, 3, 1)
    bbox = _conv(sd, 'rpn.rpn_bbox_pred', x, A, bias=True).permute(0, 2, 3,
                                                                  1)
    b, fh, fw, a2 = cls.shape
    na = a2 // 2
    scores = torch.softmax(torch.stack([cls[..., :na], cls[..., na:]], -1),
                           -1)[..., 1].reshape(b, -1)
    terms = F.conv2d(x.abs(), sd['rpn.rpn_bbox_pred.weight'].abs(),
                     sd['rpn.rpn_bbox_pred.bias'].abs()).permute(0, 2, 3, 1)
    return scores, bbox.reshape(b, -1, 4), fh, fw, terms.reshape(b, -1, 4)


def proposals(scores, deltas, fh: int, fw: int, im_info, cfg: dict,
              A: Arith):
    """rois (B, post, 4) and their mask (B, post) from the RPN's outputs:
    decode, clip to the image, anchors centred outside it dropped, the
    top RPN_PRE_NMS_TOP_N by score (ties in anchor order), greedy NMS,
    the first RPN_POST_NMS_TOP_N kept."""
    anc = anchors(fh, fw, cfg['anchor_scales'], cfg['anchor_ratios'],
                  scores.device)
    b, post = scores.shape[0], cfg['rpn_post_nms_top_n']
    rois = torch.zeros((b, post, 4), device=scores.device)
    mask = torch.zeros((b, post), dtype=torch.bool, device=scores.device)
    for i in range(b):
        h, w = im_info[i, 0], im_info[i, 1]
        boxes = A.decode(decode(anc, A.decode(deltas[i])))
        boxes = torch.stack([boxes[:, 0].clamp(0, w - 1),
                             boxes[:, 1].clamp(0, h - 1),
                             boxes[:, 2].clamp(0, w - 1),
                             boxes[:, 3].clamp(0, h - 1)], -1)
        inside = (((anc[:, 0] + anc[:, 2]) * 0.5 < w)
                  & ((anc[:, 1] + anc[:, 3]) * 0.5 < h))
        s = torch.where(inside, A.decode(scores[i]), NEG)
        order = torch.sort(s, descending=True, stable=True).indices
        order = order[:cfg['rpn_pre_nms_top_n']]
        keep = greedy_nms(boxes[order], s[order] > NEG,
                          cfg['rpn_nms_thresh'], post)
        rois[i, :len(keep)] = boxes[order[keep]]
        mask[i, :len(keep)] = True
    return rois, mask


# ------------------------------------------------------------- heads --

def crop_and_resize(feat, boxes, size: int):
    """feat (H, W, C); boxes (R, 4) normalised (y1, x1, y2, x2) ->
    (R, size, size, C), tf.image.crop_and_resize's bilinear."""
    h, w, _ = feat.shape
    y1, x1, y2, x2 = boxes.unbind(-1)
    g = torch.arange(size, dtype=torch.float32, device=feat.device)
    ys = y1[:, None] * (h - 1) + g * ((y2 - y1) * (h - 1) / (size - 1))[
        :, None]
    xs = x1[:, None] * (w - 1) + g * ((x2 - x1) * (w - 1) / (size - 1))[
        :, None]

    def taps(c, n):
        c0 = torch.floor(c)
        return (c0.clamp(0, n - 1).long(), (c0 + 1).clamp(0, n - 1).long(),
                c - c0, (c >= 0) & (c <= n - 1))

    y0, y1i, fy, vy = taps(ys, h)
    x0, x1i, fx, vx = taps(xs, w)

    def at(yy, xx):
        return feat[yy[:, :, None], xx[:, None, :]]       # (R, S, S, C)

    fy, fx = fy[:, :, None, None], fx[:, None, :, None]
    top = at(y0, x0) + (at(y0, x1i) - at(y0, x0)) * fx
    bot = at(y1i, x0) + (at(y1i, x1i) - at(y1i, x0)) * fx
    out = top + (bot - top) * fy
    return out * (vy[:, :, None] & vx[:, None, :])[..., None]


def heads(sd, net: str, feat, rois, num_classes: int, cfg: dict, A: Arith,
          block: int = 600):
    """Class logits (B, R, C), un-normalised box deltas (B, R, 4C) and
    the tail's features (B, R, F) at image-space rois (B, R, 4) over NCHW
    features."""
    b, _, fh, fw = feat.shape
    fmap = feat.permute(0, 2, 3, 1)
    hgt, wid = (fh - 1.0) * STRIDE, (fw - 1.0) * STRIDE
    norm = torch.stack([rois[..., 1] / hgt, rois[..., 0] / wid,
                        rois[..., 3] / hgt, rois[..., 2] / wid], -1)
    vgg = net == 'vgg16'
    size = cfg['pooling_size'] * (2 if vgg else 1)
    stds = torch.tensor(BBOX_STDS * num_classes, device=feat.device)
    means = torch.tensor(BBOX_MEANS * num_classes, device=feat.device)
    scores, deltas, feats = [], [], []
    for i in range(b):
        for r0 in range(0, rois.shape[1], block):
            crops = crop_and_resize(fmap[i], norm[i, r0:r0 + block], size)
            if vgg:
                crops = F.max_pool2d(crops.permute(0, 3, 1, 2), 2, 2,
                                     ceil_mode=True).permute(0, 2, 3, 1)
            f = tail(sd, net, crops, A)
            feats.append(f)
            scores.append(A.linear(f, sd['rcnn.cls_score.weight'],
                                   sd['rcnn.cls_score.bias']))
            deltas.append(A.linear(f, sd['rcnn.bbox_pred.weight'],
                                   sd['rcnn.bbox_pred.bias']) * stds + means)
    r = rois.shape[1]
    return (torch.cat(scores).reshape(b, r, -1),
            torch.cat(deltas).reshape(b, r, -1),
            torch.cat(feats).reshape(b, r, -1))


def head_terms(sd, feats, num_classes: int):
    """The size of the terms each head output sums, |W| |f| + |b| (box
    deltas times the training stds): the scale that rounding of the
    operands errs against."""
    stds = torch.tensor(BBOX_STDS * num_classes, device=feats.device)
    f = feats.abs()
    return (f @ sd['rcnn.cls_score.weight'].abs().T
            + sd['rcnn.cls_score.bias'].abs(),
            (f @ sd['rcnn.bbox_pred.weight'].abs().T
             + sd['rcnn.bbox_pred.bias'].abs()) * stds)
