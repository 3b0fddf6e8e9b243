"""Evaluation (counterpart of `tpudenoise/eval/harness.py`).

One eval chunk is `detect_chunk`: per-image `fold_in` keys -> fused noise
kernel -> per test scale, device prep (mean-subtract, bilinear rescale,
bucket pad) and the batched detector forward (packed NMS kernel inside)
-> one per-class NMS (over the union of the scales' candidates for a
TEST.SCALES pyramid).  `test_net_batched` runs chunks over a dataset
with device prep (or, with device_prep=False, the JAX package's cv2
resize on the host: a CPU parity path, since the GPU machine has no cv2),
on one device or split over the ranks of a process group (`core.mesh`),
datasets of several image shapes (VOC, COCO) through per-orientation
noise buckets and the bucketed (masked) noise.
`test_net` is the reference's one-image loop.  With `compute_id` both
loops also pool the backbone's activations at the TwoNN probe points of
each image's detector input (`analysis/twonn.py`; one more head forward a
chunk) and report the per-layer intrinsic dimension after the loop;
`fast_rng` builds the noise with the counter-hash draws.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpudenoise_torch.core import mesh as M
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import get_output_dir
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.ops.boxes import (bbox_transform_inv,
                                        clip_boxes_lower_only)
from tpudenoise_torch.ops.nms import NEG_INF, nms_fixpoint
from tpudenoise_torch.ops.resize import prep_on_device
from tpudenoise_torch.utils.blob import (derive_bucket, pad_to_bucket,
                                         prep_im_for_blob, rescale_geometry)
from tpudenoise_torch.utils.image_io import image_hw, read_bgr
from tpudenoise_torch.utils.logging import get_metrics_logger
from tpudenoise_torch.utils.timer import Timer


def _log_det_scores(dets: np.ndarray, image_index: int):
    """One 'score' scalar summary per confident (>= 0.8) detection,
    stepped by image index, as the reference writes them during eval; a
    no-op without a TensorBoard or wandb sink."""
    logger = get_metrics_logger()
    if not logger.active_sinks or len(dets) == 0:
        return
    for s in dets[dets[:, -1] >= 0.8, -1]:
        logger.log_scalar_quiet('score', float(s), step=image_index)


def set_matmul_precision():
    """f32-exact matmuls and convs on the card: the reference asks XLA for
    HIGHEST precision in roi_align and resize, and TF32 keeps ~3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _decode(rois, bbox_pred, im_info):
    """Class boxes of (N, R, 4) rois and (N, R, 4C) deltas in
    original-image coordinates: each row through its own im_info (N, 3)
    scale, clipped below and to the original extent."""
    scale = im_info[:, 2]
    boxes = rois / scale[:, None, None]
    pred = bbox_transform_inv(boxes, bbox_pred)
    orig_hw = (torch.round(im_info[:, 0] / scale),
               torch.round(im_info[:, 1] / scale))
    return clip_boxes_lower_only(pred, orig_hw)


def postprocess_detections(rois, roi_mask, cls_prob, bbox_pred, im_info,
                           num_classes: int, nms_thresh: float,
                           score_thresh: float, max_per_class: int = 100):
    """Decode class boxes into original-image coordinates and run the
    per-class NMS, batched: rois (B, R, 4), roi_mask (B, R), cls_prob
    (B, R, C), bbox_pred (B, R, 4C), im_info (B, 3).  Returns boxes
    (B, C-1, M, 4), scores (B, C-1, M) and mask (B, C-1, M) for the
    foreground classes.  The one-level case of
    `postprocess_detections_pyramid`."""
    return postprocess_detections_pyramid(
        rois[:, None], roi_mask[:, None], cls_prob[:, None],
        bbox_pred[:, None], im_info[:, None], num_classes, nms_thresh,
        score_thresh, max_per_class)


def postprocess_detections_pyramid(rois, roi_masks, cls_probs, bbox_preds,
                                   im_infos, num_classes: int,
                                   nms_thresh: float, score_thresh: float,
                                   max_per_class: int = 100):
    """The multi-scale merge, batched: decode each pyramid level through
    its own scale into original-image coordinates, pool the levels'
    candidates, then one per-class NMS over the union (B x (C-1)
    problems of S * R boxes).  Level arrays are stacked on axis 1: rois
    (B, S, R, 4), roi_masks (B, S, R), cls_probs (B, S, R, C),
    bbox_preds (B, S, R, 4C), im_infos (B, S, 3).  Returns as
    `postprocess_detections`."""
    b, s, r = rois.shape[:3]
    pred = _decode(rois.reshape(b * s, r, 4),
                   bbox_preds.reshape(b * s, r, -1),
                   im_infos.reshape(b * s, 3))
    pred = pred.reshape(b, s * r, num_classes, 4)
    boxes = pred[:, :, 1:].permute(0, 2, 1, 3)              # (B, C-1, N, 4)
    scores = cls_probs.reshape(b, s * r, num_classes)[:, :, 1:].permute(
        0, 2, 1)                                            # (B, C-1, N)
    valid = roi_masks.reshape(b, 1, s * r) & (scores > score_thresh)
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


def derive_noise_buckets(shapes):
    """The noise buckets of a set of raw (h, w) image shapes: None when
    every image shares one shape, else one bucket per orientation
    ('p' for h > w, 'l' otherwise), the largest extent of that
    orientation's shapes."""
    if len(set(shapes)) <= 1:
        return None
    buckets = {}
    for h, w in shapes:
        o = 'p' if h > w else 'l'
        bh, bw = buckets.get(o, (0, 0))
        buckets[o] = (max(bh, h), max(bw, w))
    return buckets


def _pad_raw_to_bucket(im: np.ndarray, bucket) -> np.ndarray:
    """Edge-pad a raw (h, w, 3) image to the noise bucket, so that the
    denoise stencils see plausible pixels at the valid boundary (the pad
    is cropped away after the noise)."""
    h, w = im.shape[:2]
    bh, bw = bucket
    return np.pad(im, ((0, bh - h), (0, bw - w), (0, 0)), mode='edge')


def noise_chunk(key, idx, raw_u8: torch.Tensor, noise_fn,
                hw=None) -> torch.Tensor:
    """detect_chunk's noise stage: one `fold_in` key per image index of
    idx, then noise_fn's keyed noise over raw_u8 (B, H, W, 3), or with
    hw (each image's valid (h, w), host ints) its bucketed form over
    edge-padded canvases."""
    keys = prng.fold_in(key, np.asarray(idx))
    if hw is None:
        return noise_fn.keyed(keys, raw_u8)
    return noise_fn.masked(keys, raw_u8, hw)


def chunk_levels(shapes, t_sizes, m_size: int, bucket, device) -> list:
    """The levels of a chunk of raw (h, w) shapes of one orientation, one
    per test scale ts of t_sizes: (geom, bucket), geom (B, 5) f32 rows
    (h0, w0, oh, ow, scale) and bucket the given one or that
    orientation's at ts.  Each image is checked against its bucket: one
    too small would cut the image's edge while im_info still reports
    (oh, ow)."""
    portrait = shapes[0][0] > shapes[0][1]
    levels = []
    for ts in t_sizes:
        img_bucket = bucket or derive_bucket(ts, m_size, portrait=portrait)
        rows = []
        for h0, w0 in shapes:
            s, oh, ow = rescale_geometry(h0, w0, ts, m_size)
            if oh > img_bucket[0] or ow > img_bucket[1]:
                raise ValueError(f'image {oh}x{ow} exceeds bucket '
                                 f'{img_bucket}')
            rows.append((h0, w0, oh, ow, s))
        levels.append((torch.tensor(rows, dtype=torch.float32,
                                    device=device), img_bucket))
    return levels


def detect_noisy(model, params, noisy: torch.Tensor, levels,
                 thresh: float = 0.0, max_per_image: int = 100,
                 on_stage=None, probe=None, prep=None):
    """detect_chunk's stages after the noise: for each level (geom,
    bucket) of levels (`chunk_levels`; one per test scale), device prep
    of the noisy (B, H, W, 3) frames into that level's bucket (or
    prep(noisy, level index), when given) and the forward; then
    `postprocess_detections_pyramid` over the levels (for one level,
    `postprocess_detections`).  on_stage as in detect_chunk ('prep' and
    'forward' once a level, then 'postprocess'); probe(imgs), when given,
    receives the first level's prepped batch (the TwoNN probes)."""
    mark = on_stage or (lambda name: None)
    outs = []
    for li, (geom, bucket) in enumerate(levels):
        imgs = (prep_on_device(noisy, geom, model.cfg.PIXEL_MEANS, bucket)
                if prep is None else prep(noisy, li))
        mark('prep')
        if probe is not None and not outs:
            probe(imgs)
        outs.append(model.forward_test(params, imgs, geom[:, 2:]))
        mark('forward')

    def stack(name):
        return torch.stack([o[name] for o in outs], 1)

    res = postprocess_detections_pyramid(
        stack('rois'), stack('roi_mask'), stack('cls_prob'),
        stack('bbox_pred'), torch.stack([g[:, 2:] for g, _ in levels], 1),
        model.num_classes, model.cfg.TEST.NMS, thresh,
        max_per_class=max_per_image)
    mark('postprocess')
    return res


def detect_chunk(model, params, key, idx, raw_u8: torch.Tensor, levels,
                 noise_fn, hw=None, thresh: float = 0.0,
                 max_per_image: int = 100, on_stage=None, probe=None,
                 prep=None):
    """One eval chunk, all on the images' device: `noise_chunk`, then
    `detect_noisy`.

    key: (2,) uint32 PRNG key; idx: image indices (one per raw image);
    raw_u8: (B, H, W, 3) uint8 (or u8-domain f32) BGR frames; levels:
    per test scale (geom, bucket), geom (B, 5) f32 rows (h0, w0, oh, ow,
    scale) and bucket the padded (H, W) (`chunk_levels`); noise_fn from
    `make_pipeline`; hw as `noise_chunk` (the frames edge-padded
    canvases).  on_stage(name), when given, is called after each of the
    stages 'noise', 'prep', 'forward' and 'postprocess' has been
    enqueued; probe and prep as in `detect_noisy`.  Returns per-class boxes,
    scores and mask, (B, C-1, max_per_image, ...).
    """
    noisy = noise_chunk(key, idx, raw_u8, noise_fn, hw)
    if on_stage:
        on_stage('noise')
    return detect_noisy(model, params, noisy, levels, thresh,
                        max_per_image, on_stage, probe, prep)


def host_prep(noisy: torch.Tensor, shapes, t_size: int, m_size: int,
              bucket, pixel_means) -> torch.Tensor:
    """The JAX package's host prep of a noisy chunk (B, H, W, 3) on one
    test scale: each image cropped to its raw (h, w) of shapes, then
    `utils.blob.prep_im_for_blob` (mean subtraction and cv2's bilinear
    resize, on the host) and a zero pad to bucket; back on noisy's
    device.  Needs cv2 (ImportError without it)."""
    means = np.asarray(pixel_means, np.float32).reshape(3)
    frames = noisy.cpu().numpy()
    out = []
    for frame, (h, w) in zip(frames, shapes):
        im, _ = prep_im_for_blob(frame[:h, :w], means, t_size, m_size)
        out.append(pad_to_bucket(im, bucket)[0])
    return torch.from_numpy(np.stack(out)).to(noisy.device)


def _collect(all_boxes, i, bx, sc, mk, max_per_image: int):
    """Image i's detections (one image's per-class numpy boxes, scores
    and mask) into all_boxes after the global cap; the score summaries
    take the detections before the cap, as the reference writes them
    before its max_per_image cap."""
    mki = limit_per_image(bx, sc, mk, max_per_image)
    log_scores = get_metrics_logger().active_sinks
    for cls in range(1, len(all_boxes)):
        sel = mki[cls - 1]
        all_boxes[cls][i] = np.hstack(
            [bx[cls - 1][sel], sc[cls - 1][sel][:, None]]).astype(np.float32)
        if log_scores:
            _log_det_scores(sc[cls - 1][mk[cls - 1]][:, None], i)


class _Probes:
    """The compute_id features: per probe point, one pooled row per
    image, in image order (`analysis.twonn.make_probe_fn` over each
    chunk's detector input, pooled over each image's valid (oh, ow))."""

    def __init__(self, model, params, t_size: int, m_size: int):
        from tpudenoise_torch.analysis.twonn import make_probe_fn
        self.fn = make_probe_fn(model)
        self.params, self.t_size, self.m_size = params, t_size, m_size
        self.feats = {}

    def hook(self, shapes, n_real: int, gather=None):
        """probe(imgs) for detect_chunk, shapes the raw (h, w) of imgs'
        images; gather, when given, joins every rank's rows of the
        features (the chunk's n_real images are the joined rows')."""
        hw = [rescale_geometry(h, w, self.t_size, self.m_size)[1:]
              for h, w in shapes]

        def probe(imgs):
            feats = self.fn(self.params, imgs, hw)
            if gather is not None:
                feats = gather(feats)
            for p, v in feats.items():
                self.feats.setdefault(p, []).extend(
                    v[:n_real].cpu().numpy())
        return probe


def _raw_shapes(imdb_obj):
    return [image_hw(imdb_obj.image_path_at(i))
            for i in range(imdb_obj.num_images)]


def test_net_batched(model, params, imdb_obj, weights_filename: str,
                     noise: str, eval_batch: int = 8,
                     max_per_image: int = 100, thresh: float = 0.0,
                     config=None, bucket=None, strict_ref: bool = False,
                     compute_id: bool = False, mesh='auto',
                     device_prep: bool = True, fast_rng: bool = False):
    """Batched evaluation over an imdb-protocol object (`num_images`,
    `num_classes`, `image_path_at`, `name`, `evaluate_detections`) on the
    device of the model's parameters.

    Images are grouped by raw shape when the dataset has one, else by
    per-orientation noise bucket (`derive_noise_buckets`): each image is
    edge-padded to its bucket and the noise runs in its bucketed form
    with the valid extents, so at most two noise shapes run.  Each group
    runs in chunks of `eval_batch`, a partial chunk padded with its last
    index (those results are dropped).  Per chunk: the noise once, then
    per scale of TEST.SCALES the prep and the forward, and the per-class
    NMS (over the union of the scales' candidates for a pyramid):
    `detect_chunk`.  A worker thread reads chunk k + 1 while chunk k
    runs.

    device_prep=False preps on the host as the JAX package's
    `device_prep=False` does (`host_prep`: cv2's resize; the noise stays
    on the device).  mesh='auto' takes `core.mesh.production_mesh`: with
    a process group of several ranks that divide eval_batch, each rank
    reads and runs its rows of every chunk (the per-image fold_in keys
    make its noise the single device's), and the detections (and the
    compute_id features) are gathered; rank 0 writes detections.pkl and
    evaluates, the other ranks return None.  mesh=None runs on one
    device; a DeviceMesh with a 'data' axis is used as given.
    Images are read through `utils.image_io`: `.npy` pixels need neither
    cv2 nor PIL.  Writes detections.pkl and returns
    imdb_obj.evaluate_detections(...)."""
    C = config or model.cfg
    set_matmul_precision()
    device = next(model.parameters()).device
    if mesh == 'auto':
        mesh = M.production_mesh(C, eval_batch)
    rows = slice(0, eval_batch)
    gather = None
    if mesh is not None:
        rows = M.batch_rows(mesh, eval_batch)
        gather = lambda tree: M.gather_batch(mesh, tree)
        print(f'evaluating on a {M.axis_size(mesh)}-rank mesh (rows '
              f'{rows.start}..{rows.stop - 1} of each chunk here)')
    num_images, num_classes = imdb_obj.num_images, imdb_obj.num_classes
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(num_classes)]
    output_dir = get_output_dir(imdb_obj.name, weights_filename, C)
    noise_fn = make_pipeline(noise, mode='TEST', strict_ref=strict_ref,
                             fast_rng=fast_rng)
    print(f'noise pipeline backend: {noise_fn.backend}')
    key = prng.PRNGKey(C.RNG_SEED)
    t_sizes, m_size = tuple(C.TEST.SCALES), C.TEST.MAX_SIZE
    if len(t_sizes) > 1:
        print(f'multi-scale test pyramid: SCALES={t_sizes}')
    probes = (_Probes(model, params, t_sizes[0], m_size) if compute_id
              else None)

    raw_shapes = _raw_shapes(imdb_obj)
    noise_buckets = derive_noise_buckets(raw_shapes)
    if noise_buckets:
        print(f'noise buckets: {noise_buckets} '
              f'({len(set(raw_shapes))} distinct raw shapes)')
    groups = defaultdict(list)
    for i, (h, w) in enumerate(raw_shapes):
        groups[noise_buckets['p' if h > w else 'l'] if noise_buckets
               else (h, w)].append(i)
    chunks = []
    for nhw, idxs in groups.items():
        for c0 in range(0, len(idxs), eval_batch):
            chunk = idxs[c0:c0 + eval_batch]
            chunks.append((nhw, chunk + [chunk[-1]] * (eval_batch
                                                       - len(chunk)),
                           len(chunk)))

    def load(nhw, chunk):
        ims = [read_bgr(imdb_obj.image_path_at(i)) for i in chunk[rows]]
        if noise_buckets:
            ims = [_pad_raw_to_bucket(im, nhw) for im in ims]
        return np.stack(ims)

    def host_prep_fn(shapes, levels_):
        def prep(noisy, li):
            return host_prep(noisy, shapes, t_sizes[li], m_size,
                             levels_[li][1], C.PIXEL_MEANS)
        return prep

    timers = {'im_detect': Timer(), 'misc': Timer()}
    # the levels of each distinct chunk of shapes, built once
    levels = {}
    done = 0
    with ThreadPoolExecutor(max_workers=1) as ex:
        nxt = ex.submit(load, *chunks[0][:2]) if chunks else None
        for ci, (nhw, chunk, n_real) in enumerate(chunks):
            timers['im_detect'].tic()
            raw = torch.from_numpy(nxt.result()).to(device)
            if ci + 1 < len(chunks):
                nxt = ex.submit(load, *chunks[ci + 1][:2])
            mine = chunk[rows]
            shapes = tuple(raw_shapes[i] for i in mine)
            if shapes not in levels:
                levels[shapes] = chunk_levels(shapes, t_sizes, m_size,
                                              bucket, device)
            res = detect_chunk(
                model, params, key, mine, raw, levels[shapes], noise_fn,
                shapes if noise_buckets else None, thresh, max_per_image,
                probe=probes and probes.hook(shapes, n_real, gather),
                prep=None if device_prep else host_prep_fn(
                    shapes, levels[shapes]))
            if gather is not None:
                res = gather(res)
            bx, sc, mk = (t.cpu().numpy() for t in res)
            timers['im_detect'].toc()
            timers['misc'].tic()
            for j, i in enumerate(chunk[:n_real]):
                _collect(all_boxes, i, bx[j], sc[j], mk[j], max_per_image)
            timers['misc'].toc()
            done += n_real
            print(f'im_detect: {done:d}/{num_images:d} '
                  f'{timers["im_detect"].average_time:.3f}s/chunk '
                  f'{timers["misc"].average_time:.3f}s')

    return _write_and_evaluate(imdb_obj, all_boxes, output_dir,
                               probes and probes.feats)


def test_net(model, params, imdb_obj, weights_filename: str, noise: str,
             max_per_image: int = 100, thresh: float = 0.0, config=None,
             bucket=None, strict_ref: bool = False,
             compute_id: bool = False, fast_rng: bool = False):
    """The reference's one-image evaluation loop (`harness.py:159-310`)
    on the device of the model's parameters.  Per image: the noise at the
    raw resolution with the key fold_in(key, i) (as `noise_fn(fold_in(key,
    i), im[None])`), or on a dataset of several shapes (and not
    strict_ref) the bucketed form on the image's orientation bucket,
    cropped back to (h0, w0); then `detect_noisy`: per scale of
    TEST.SCALES device prep and one forward, and the per-class NMS (over
    the union of the scales' candidates for a pyramid).

    The JAX package preps each image on the host with cv2; no machine
    this port runs on is sure to have cv2, so the prep runs on the device
    (`ops/resize.prep_on_device`), as in `test_net_batched`.  That is
    exact at scale 1 and within the resize's float tail elsewhere (f32
    coordinates: at most ~0.05 u8 levels, `tpudenoise/eval/harness.py:
    386-398`).  Writes detections.pkl and returns
    imdb_obj.evaluate_detections(...)."""
    C = config or model.cfg
    set_matmul_precision()
    device = next(model.parameters()).device
    num_images, num_classes = imdb_obj.num_images, imdb_obj.num_classes
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(num_classes)]
    output_dir = get_output_dir(imdb_obj.name, weights_filename, C)
    noise_fn = make_pipeline(noise, mode='TEST', strict_ref=strict_ref,
                             fast_rng=fast_rng)
    print(f'noise pipeline backend: {noise_fn.backend}')
    key = prng.PRNGKey(C.RNG_SEED)
    t_sizes, m_size = tuple(C.TEST.SCALES), C.TEST.MAX_SIZE
    if len(t_sizes) > 1:
        print(f'multi-scale test pyramid: SCALES={t_sizes}')
    probes = (_Probes(model, params, t_sizes[0], m_size) if compute_id
              else None)
    raw_shapes = _raw_shapes(imdb_obj)
    # strict_ref keeps the exact-size noise (one shape per distinct raw
    # shape): bucketing changes the draws' layout
    noise_buckets = None if strict_ref else derive_noise_buckets(raw_shapes)
    if noise_buckets:
        print(f'noise buckets: {noise_buckets} '
              f'({len(set(raw_shapes))} distinct raw shapes)')

    timers = {'im_detect': Timer(), 'misc': Timer()}
    for i in range(num_images):
        im = read_bgr(imdb_obj.image_path_at(i))
        timers['im_detect'].tic()
        h0, w0 = im.shape[:2]
        hw = None
        if noise_buckets is not None:
            im = _pad_raw_to_bucket(im, noise_buckets['p' if h0 > w0
                                                      else 'l'])
            hw = [(h0, w0)]
        noisy = noise_chunk(key, [i], torch.from_numpy(im[None]).to(device),
                            noise_fn, hw)[:, :h0, :w0]
        res = detect_noisy(model, params, noisy, chunk_levels(
            [(h0, w0)], t_sizes, m_size, bucket, device), thresh,
            max_per_image, probe=probes and probes.hook([(h0, w0)], 1))
        bx, sc, mk = (t.cpu().numpy()[0] for t in res)
        timers['im_detect'].toc()
        timers['misc'].tic()
        _collect(all_boxes, i, bx, sc, mk, max_per_image)
        timers['misc'].toc()
        if (i + 1) % 20 == 0 or i == num_images - 1:
            print(f'im_detect: {i + 1:d}/{num_images:d} '
                  f'{timers["im_detect"].average_time:.3f}s '
                  f'{timers["misc"].average_time:.3f}s')

    return _write_and_evaluate(imdb_obj, all_boxes, output_dir,
                               probes and probes.feats)


def _write_and_evaluate(imdb_obj, all_boxes, output_dir, feats):
    """detections.pkl, the TwoNN IDs and the evaluation, on rank 0 (the
    only process without a process group); None on the other ranks."""
    if M.rank() != 0:
        return None
    with open(os.path.join(output_dir, 'detections.pkl'), 'wb') as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    _finish_eval(output_dir, feats)
    return imdb_obj.evaluate_detections(all_boxes, output_dir)


def _finish_eval(output_dir, feats=None):
    """After the loop: with compute_id features of 10 images or more, the
    TwoNN intrinsic dimension per probe layer (10 resamples), printed and
    logged as twonn_id/<probe> and twonn_id_err/<probe>; then the
    evaluation's banner."""
    if feats and len(next(iter(feats.values()))) >= 10:
        from tpudenoise_torch.analysis.twonn import per_layer_id
        ids = per_layer_id({p: np.stack(v) for p, v in feats.items()},
                           nres=10)
        print('TwoNN intrinsic dimension per probe layer:')
        logs = {}
        for p, (mean_id, err_id) in ids.items():
            print(f'  {p:28s} {mean_id:6.2f} +/- {err_id:.2f}')
            logs[f'twonn_id/{p}'] = mean_id
            logs[f'twonn_id_err/{p}'] = err_id
        get_metrics_logger().log(logs)
    print(f'Evaluating detections (artifacts in {output_dir})')
