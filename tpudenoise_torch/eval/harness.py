"""Batched evaluation (counterpart of `tpudenoise/eval/harness.py`).

One eval chunk is `detect_chunk`: per-image `fold_in` keys -> fused noise
kernel -> device prep (mean-subtract, bilinear rescale, bucket pad) ->
batched detector forward (packed NMS kernel inside) -> per-class NMS.
`test_net_batched` runs it over a dataset on its single-scale,
device-prep, single-device path.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import get_output_dir
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.ops.boxes import (bbox_transform_inv,
                                        clip_boxes_lower_only)
from tpudenoise_torch.ops.nms import NEG_INF, nms_fixpoint
from tpudenoise_torch.ops.resize import prep_on_device


def set_matmul_precision():
    """f32-exact matmuls and convs on the card: the reference asks XLA for
    HIGHEST precision in roi_align and resize, and TF32 keeps ~3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def postprocess_detections(rois, roi_mask, cls_prob, bbox_pred, im_info,
                           num_classes: int, nms_thresh: float,
                           score_thresh: float, max_per_class: int = 100):
    """Decode class boxes into original-image coordinates and run the
    per-class NMS, batched: rois (B, R, 4), roi_mask (B, R), cls_prob
    (B, R, C), bbox_pred (B, R, 4C), im_info (B, 3).  Returns boxes
    (B, C-1, M, 4), scores (B, C-1, M) and mask (B, C-1, M) for the
    foreground classes."""
    scale = im_info[:, 2]
    boxes = rois / scale[:, None, None]
    pred = bbox_transform_inv(boxes, bbox_pred)
    orig_hw = (torch.round(im_info[:, 0] / scale),
               torch.round(im_info[:, 1] / scale))
    pred = clip_boxes_lower_only(pred, orig_hw)
    b, r = rois.shape[:2]
    pred = pred.reshape(b, r, num_classes, 4)
    return _per_class_nms(pred, cls_prob, roi_mask, nms_thresh,
                          score_thresh, max_per_class)


def _per_class_nms(pred, cls_prob, roi_mask, nms_thresh, score_thresh,
                   max_per_class):
    """One NMS batched over (image, foreground class)."""
    boxes = pred[:, :, 1:].permute(0, 2, 1, 3)              # (B, C-1, R, 4)
    scores = cls_prob[:, :, 1:].permute(0, 2, 1)           # (B, C-1, R)
    valid = roi_mask[:, None, :] & (scores > score_thresh)
    keep, kmask = nms_fixpoint(boxes, scores, nms_thresh, max_per_class,
                               valid=valid)
    safe = keep.clamp(min=0).to(torch.int64)
    kb = torch.gather(boxes, 2, safe[..., None].expand(*safe.shape, 4))
    ks = torch.gather(scores, 2, safe)
    return (torch.where(kmask[..., None], kb, 0.0),
            torch.where(kmask, ks, NEG_INF), kmask)


def limit_per_image(boxes_c, scores_c, mask_c, max_per_image: int):
    """Global top max_per_image across classes, on the host over numpy
    arrays of one image."""
    scores = np.where(mask_c, scores_c, -np.inf).ravel()
    if (scores > -np.inf).sum() > max_per_image:
        thresh = np.sort(scores[scores > -np.inf])[-max_per_image]
        mask_c = mask_c & (scores_c >= thresh)
    return mask_c


def detect_chunk(model, params, key, idx, raw_u8: torch.Tensor,
                 geom: torch.Tensor, infos: torch.Tensor, noise_fn,
                 bucket: tuple, thresh: float = 0.0,
                 max_per_image: int = 100, on_stage=None):
    """One eval chunk, all on the images' device.

    key: (2,) uint32 PRNG key; idx: image indices (one per raw image);
    raw_u8: (B, H, W, 3) uint8 (or u8-domain f32) BGR frames; geom (B, 5)
    f32 rows (h0, w0, oh, ow, scale); infos (B, 3) = (oh, ow, scale);
    noise_fn from `make_pipeline`; bucket the padded (H, W).
    on_stage(name), when given, is called after each of the stages
    'noise', 'prep', 'forward' and 'postprocess' has been enqueued.
    Returns per-class boxes, scores and mask, (B, C-1, max_per_image, ...).
    """
    mark = on_stage or (lambda name: None)
    keys = prng.fold_in(key, np.asarray(idx))
    noisy = noise_fn.keyed(keys, raw_u8)
    mark('noise')
    imgs = prep_on_device(noisy, geom, model.cfg.PIXEL_MEANS, bucket)
    mark('prep')
    out = model.forward_test(params, imgs, infos)
    mark('forward')
    res = postprocess_detections(
        out['rois'], out['roi_mask'], out['cls_prob'], out['bbox_pred'],
        infos, model.num_classes, model.cfg.TEST.NMS, thresh,
        max_per_class=max_per_image)
    mark('postprocess')
    return res


def _not_ported(what: str, item: str):
    raise NotImplementedError(f'{what} is not ported yet (ROADMAP {item})')


def test_net_batched(model, params, imdb_obj, weights_filename: str,
                     noise: str, eval_batch: int = 8,
                     max_per_image: int = 100, thresh: float = 0.0,
                     config=None, bucket=None, strict_ref: bool = False,
                     compute_id: bool = False, mesh=None,
                     device_prep: bool = True, fast_rng: bool = False):
    """Batched evaluation over an imdb-protocol object (`num_images`,
    `num_classes`, `image_path_at`, `name`, `evaluate_detections`) on the
    device of the model's parameters.  All images must share one raw
    shape (as rrData's do); they run in chunks of `eval_batch` through
    `detect_chunk`.  Writes detections.pkl and returns
    imdb_obj.evaluate_detections(...)."""
    import cv2
    import PIL.Image
    from tpudenoise.utils.blob import derive_bucket, rescale_geometry
    if compute_id:
        _not_ported('compute_id (TwoNN probes)', 'Queue 1 item 14')
    if mesh is not None:
        _not_ported('the device mesh', 'Queue 1 item 16')
    if not device_prep:
        _not_ported('host prep (device_prep=False)', 'Queue 1 item 6')
    if fast_rng:
        _not_ported('fast_rng', 'Queue 1 item 8')
    C = config or model.cfg
    if len(C.TEST.SCALES) > 1:
        _not_ported('the multi-scale test pyramid', 'Queue 1 item 6')
    set_matmul_precision()
    device = next(model.parameters()).device
    num_images, num_classes = imdb_obj.num_images, imdb_obj.num_classes
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(num_classes)]
    output_dir = get_output_dir(imdb_obj.name, weights_filename, C)
    noise_fn = make_pipeline(noise, mode='TEST', strict_ref=strict_ref)
    print(f'noise pipeline backend: {noise_fn.backend}')
    key = prng.PRNGKey(C.RNG_SEED)
    t_size, m_size = C.TEST.SCALES[0], C.TEST.MAX_SIZE

    shapes = {PIL.Image.open(imdb_obj.image_path_at(i)).size[::-1]
              for i in range(num_images)}
    if len(shapes) > 1:
        _not_ported('noise buckets for datasets of several image shapes',
                    'Queue 1 item 6')
    (h0, w0), = shapes
    img_bucket = bucket or derive_bucket(t_size, m_size, portrait=h0 > w0)
    s, oh, ow = rescale_geometry(h0, w0, t_size, m_size)
    assert oh <= img_bucket[0] and ow <= img_bucket[1], \
        f'image {oh}x{ow} exceeds bucket {img_bucket}'
    geom = torch.tensor([(h0, w0, oh, ow, s)] * eval_batch,
                        dtype=torch.float32, device=device)

    for c0 in range(0, num_images, eval_batch):
        chunk = list(range(c0, min(c0 + eval_batch, num_images)))
        n_real = len(chunk)
        # pad a partial chunk with its last index; those results are dropped
        chunk = chunk + [chunk[-1]] * (eval_batch - n_real)
        raw = torch.from_numpy(np.stack(
            [cv2.imread(imdb_obj.image_path_at(i)) for i in chunk])
        ).to(device)
        boxes_c, scores_c, mask_c = detect_chunk(
            model, params, key, chunk, raw, geom, geom[:, 2:],
            noise_fn, img_bucket, thresh, max_per_image)
        bx, sc, mk = (boxes_c.cpu().numpy(), scores_c.cpu().numpy(),
                      mask_c.cpu().numpy())
        for j, i in enumerate(chunk[:n_real]):
            mkj = limit_per_image(bx[j], sc[j], mk[j], max_per_image)
            for cls in range(1, num_classes):
                sel = mkj[cls - 1]
                all_boxes[cls][i] = np.hstack(
                    [bx[j][cls - 1][sel],
                     sc[j][cls - 1][sel][:, None]]).astype(np.float32)
        print(f'im_detect: {c0 + n_real:d}/{num_images:d}')

    with open(os.path.join(output_dir, 'detections.pkl'), 'wb') as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    print(f'Evaluating detections (artifacts in {output_dir})')
    return imdb_obj.evaluate_detections(all_boxes, output_dir)
