"""Batched training data loader (counterpart of `tpudenoise/data/
loader.py`): epoch shuffling with a checkpointable cursor and numpy RNG
(the same `np.random.RandomState` draws as the JAX loader), flips, the
min-side/max-side resize and fixed-shape batches

  {image (B, H, W, 3) uint8, im_info (B, 3), gt_boxes (B, G, 5),
   gt_mask (B, G)}

padded to the static bucket by edge replication (the masked noise
stage's halo contract; the solver zeroes the pad after the noise).

Pixels come through `utils.image_io.read_bgr` (`.npy` with numpy, so no
cv2 on the GPU machine).  At scale 1 (rrData: 600x1000 images, SCALES
(600,), MAX_SIZE 1000) the image is used as read, bit for bit what
`cv2.resize` returns at fx = fy = 1.  At any other scale the resize runs
in torch on the host: cv2's INTER_LINEAR geometry (`ops.resize`) in f32,
rounded half to even to u8; cv2 resizes u8 in fixed point, so a pixel
can differ from it by 1 (tests/test_torch_train_data.py holds the bound).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch.core.config import cfg as default_cfg
from tpudenoise_torch.ops.resize import resize_weights
from tpudenoise_torch.utils.blob import derive_bucket
from tpudenoise_torch.utils.image_io import read_bgr


def resize_u8(im: np.ndarray, scale: float) -> np.ndarray:
    """(H, W, 3) uint8 resized by `scale` with cv2.INTER_LINEAR's
    coordinate rule to cv2's output size, in f32, rounded to uint8."""
    h, w = im.shape[:2]
    oh, ow = int(np.round(h * scale)), int(np.round(w * scale))
    x = torch.from_numpy(np.ascontiguousarray(im)).to(torch.float32)
    wh = resize_weights(oh, h, oh, h, scale)                 # (oh, h)
    ww = resize_weights(ow, w, ow, w, scale)                 # (ow, w)
    t = torch.matmul(wh, x.reshape(h, w * 3)).reshape(oh, w, 3)
    out = torch.einsum('pw,hwc->hpc', ww, t)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


class RoiDataLoader:
    def __init__(self, roidb, num_classes: int, config=None,
                 random_seed=None, batch_size: int = 1,
                 bucket=None, max_gt: int = 100,
                 training: bool = True):
        self._roidb = roidb
        self._num_classes = num_classes
        self._cfg = config or default_cfg
        self._batch = batch_size
        if bucket is None:
            # a bucket covering every rescaled image; a portrait entry can
            # put the long side on H, so then both orientations
            C = self._cfg
            scales = C.TRAIN.SCALES if training else C.TEST.SCALES
            max_size = C.TRAIN.MAX_SIZE if training else C.TEST.MAX_SIZE
            any_portrait = any(e.get('height', 0) > e.get('width', 1)
                               for e in roidb)
            bucket = (derive_bucket(max_size, max_size) if any_portrait
                      else derive_bucket(scales[0], max_size))
        self._bucket = tuple(bucket)
        self._max_gt = max_gt
        self._training = training
        self._rng = np.random.RandomState(
            self._cfg.RNG_SEED if random_seed is None else random_seed)
        self._shuffle_roidb_inds()

    # --- the cursor protocol, checkpointable ---
    def _shuffle_roidb_inds(self):
        self._perm = self._rng.permutation(np.arange(len(self._roidb)))
        self._cur = 0

    def get_state(self):
        return {'perm': self._perm.copy(), 'cur': self._cur,
                'rng': self._rng.get_state()}

    def set_state(self, state):
        self._perm = state['perm'].copy()
        self._cur = int(state['cur'])
        self._rng.set_state(state['rng'])

    def _next_inds(self):
        if self._cur + self._batch > len(self._roidb):
            self._shuffle_roidb_inds()
        inds = self._perm[self._cur:self._cur + self._batch]
        self._cur += self._batch
        return inds

    # --- minibatch assembly ---
    def _load_image(self, entry):
        im = read_bgr(entry['image'])
        if entry.get('flipped'):
            im = im[:, ::-1, :]
        return im

    def _resize(self, im):
        C = self._cfg
        scales = C.TRAIN.SCALES if self._training else C.TEST.SCALES
        max_size = C.TRAIN.MAX_SIZE if self._training else C.TEST.MAX_SIZE
        target = scales[self._rng.randint(len(scales))]
        h, w = im.shape[:2]
        scale = float(target) / min(h, w)
        if round(scale * max(h, w)) > max_size:
            scale = float(max_size) / max(h, w)
        if scale == 1.0:
            return im, scale
        return resize_u8(im, scale), scale

    def forward(self):
        """The next fixed-shape batch, images uint8 (the device casts)."""
        inds = self._next_inds()
        bh, bw = self._bucket
        b = len(inds)
        images = np.zeros((b, bh, bw, 3), np.uint8)
        im_info = np.zeros((b, 3), np.float32)
        gt_boxes = np.zeros((b, self._max_gt, 5), np.float32)
        gt_mask = np.zeros((b, self._max_gt), bool)
        for j, i in enumerate(inds):
            entry = self._roidb[int(i)]
            im, scale = self._resize(self._load_image(entry))
            h, w = im.shape[:2]
            assert h <= bh and w <= bw, \
                f'image {h}x{w} exceeds bucket {bh}x{bw}'
            images[j, :h, :w] = im
            # edge-replicate the pad: the masked noise stage's stencils see
            # plausible halo pixels at the valid boundary
            if h < bh:
                images[j, h:, :w] = im[-1:]
            if w < bw:
                images[j, :, w:] = images[j, :, w - 1:w]
            im_info[j] = (h, w, scale)
            # gt boxes in the network input's frame
            if self._training:
                gt_inds = np.where(entry['gt_classes'] != 0)[0]
                gt_inds = gt_inds[:self._max_gt]
                n = len(gt_inds)
                gt_boxes[j, :n, :4] = (
                    entry['boxes'][gt_inds].astype(np.float32) * scale)
                gt_boxes[j, :n, 4] = entry['gt_classes'][gt_inds]
                gt_mask[j, :n] = True
        return {'image': images, 'im_info': im_info,
                'gt_boxes': gt_boxes, 'gt_mask': gt_mask}
