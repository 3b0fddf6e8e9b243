"""The training loop (counterpart of `tpudenoise/train/solver.py`): the
loader's u8 batches, the noise on the device, mean subtraction, the train
step, summaries and snapshots.

The key algebra is the JAX solver's, on the host keys of `core.prng`:
the key starts at PRNGKey(RNG_SEED) and each iteration splits it into
(key, k_noise, k_step).  `fast_rng` builds the noise pipeline with the
counter-hash draws.  A batch that fills the bucket takes the noise
pipeline's `fn(k_noise, images)`; a batch with padded images (hw below
the bucket) takes `fn.masked(fold_in(k_noise, i) per image, images, hw)`
and its pad is zeroed after the mean subtraction, as the reference's blob
pads after the noise.  With rrData's 600x1000 images in the (608, 1024)
bucket every batch is padded.

Snapshots: `{SNAPSHOT_PREFIX}_iter_{n}.pkl` holds the loader cursors and
the iteration (as the JAX solver's), and `.pt` beside it the params,
momentum, step and key (the JAX solver's orbax directory; the GPU machine
has no orbax).  `SNAPSHOT_KEPT` prunes the oldest; `train_model` resumes
from the newest, exactly: the same batches and keys follow.
`models.convert.save_params_npz` writes a snapshot's params as the shared
`.npz`, which the JAX package's `load_pretrained` reads.

Data parallelism (`core.mesh.production_mesh`: a process group of more
than one rank and a batch they divide): every rank runs the same seeded
loader and keeps its rows of each batch, so the global batch and the
exact resume are the single device's.  As in the JAX solver, the noise
then takes `fn.keyed` (or `fn.masked`) with fold_in(k_noise, i) for each
global index i, also for a batch that fills the bucket; a world of 1 has
no mesh and keeps `fn(k_noise, images)`.  The parameters are broadcast
from rank 0 after the init or restore, the step all-reduces gradients
and losses (`train_step.py`).  Only rank 0 writes snapshots and the
metrics logger's files; the ranks meet at a barrier after each snapshot
and before the restore, and take rank 0's decisions on the host clock
(summaries, the validation loader's seed).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from tpudenoise_torch.core import mesh as M
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import cfg as default_cfg
from tpudenoise_torch.data.loader import RoiDataLoader
from tpudenoise_torch.eval.harness import set_matmul_precision
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import parse as parse_noise
from tpudenoise_torch.train.train_step import TrainState, make_train_step
from tpudenoise_torch.utils.blob import derive_bucket
from tpudenoise_torch.utils.logging import MetricsLogger
from tpudenoise_torch.utils.timer import Timer
from tpudenoise_torch.utils.transfer import to_device


class Solver:
    def __init__(self, model, imdb_obj, roidb, valroidb, output_dir,
                 tb_dir, noise: str = 'original', config=None,
                 batch_size: int = 1, bucket=None, max_gt: int = 100,
                 prefetch: bool = False, device='cuda',
                 fast_rng: bool = False):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('the solver runs on a CUDA GPU unless given '
                               'device="cpu"; torch sees none here')
        # TF32 off: f32-exact matmuls and convs, as the eval path's
        set_matmul_precision()
        # the module stays where it is (its seeded init runs on the CPU):
        # every step passes the whole state dict, on the device
        self.model = model
        self.imdb = imdb_obj
        self.roidb = roidb
        self.valroidb = valroidb
        self.output_dir = output_dir
        self.cfg = config or default_cfg
        self.noise = noise
        if bucket is None:
            C = self.cfg
            any_portrait = any(e.get('height', 0) > e.get('width', 1)
                               for e in roidb)
            bucket = (derive_bucket(C.TRAIN.MAX_SIZE, C.TRAIN.MAX_SIZE)
                      if any_portrait
                      else derive_bucket(C.TRAIN.SCALES[0],
                                         C.TRAIN.MAX_SIZE))
        self.bucket = tuple(bucket)
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.prefetch = prefetch
        # rank 0 writes; without a process group, the only process does
        self.writer = M.rank() == 0
        os.makedirs(output_dir, exist_ok=True)
        self.logger = (MetricsLogger(logdir=tb_dir, tb_dir=tb_dir)
                       if self.writer else MetricsLogger())
        self._noise_fn = make_pipeline(parse_noise(noise, mode='TRAIN'),
                                       mode='TRAIN', fast_rng=fast_rng)
        print(f'noise pipeline backend: {self._noise_fn.backend}')
        self.mesh = M.production_mesh(self.cfg, batch_size)
        if self.mesh is not None:
            print(f'training on a {M.world_size()}-rank '
                  f'{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))} '
                  f'mesh')
        self._init_state_fn, self._step_fn = make_train_step(
            model, self.cfg, mesh=self.mesh)
        self._means = torch.tensor(np.asarray(self.cfg.PIXEL_MEANS,
                                              np.float32).reshape(3),
                                   device=self.device)

    # ---------------------------------------------------- snapshots ----

    def _snapshot_path(self, iter_: int) -> str:
        prefix = self.cfg.TRAIN.SNAPSHOT_PREFIX
        return osp.join(self.output_dir, f'{prefix}_iter_{iter_}')

    def snapshot(self, state: TrainState, key, loader, val_loader,
                 iter_: int) -> str:
        path = self._snapshot_path(iter_)
        if not self.writer:
            return path
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        torch.save({'params': cpu(state.params),
                    'momentum': cpu(state.momentum), 'step': state.step,
                    'key': prng.key_data(key).copy()}, path + '.pt')
        with open(path + '.pkl', 'wb') as f:
            pickle.dump({'train_cursor': loader.get_state(),
                         'val_cursor': val_loader.get_state(),
                         'iter': iter_}, f)
        print(f'Wrote snapshot to {path}')
        return path

    def _snapshot_iters(self) -> list:
        pkls = glob.glob(osp.join(
            self.output_dir, f'{self.cfg.TRAIN.SNAPSHOT_PREFIX}_iter_*.pkl'))
        return sorted(int(p.rsplit('_', 1)[1].split('.')[0]) for p in pkls)

    def remove_old_snapshots(self):
        kept = self.cfg.TRAIN.SNAPSHOT_KEPT
        for it in self._snapshot_iters()[:-kept] if kept > 0 else []:
            base = self._snapshot_path(it)
            os.remove(base + '.pkl')
            if osp.exists(base + '.pt'):
                os.remove(base + '.pt')

    def find_previous(self) -> int:
        """The newest resumable snapshot's iteration, 0 if none."""
        iters = self._snapshot_iters()
        return iters[-1] if iters else 0

    def restore(self, state: TrainState, loader, val_loader, iter_: int):
        path = self._snapshot_path(iter_)
        saved = torch.load(path + '.pt', map_location='cpu',
                           weights_only=False)
        with open(path + '.pkl', 'rb') as f:
            side = pickle.load(f)
        loader.set_state(side['train_cursor'])
        val_loader.set_state(side['val_cursor'])
        like = lambda live, got: {k: got[k].to(v.device, v.dtype)
                                  for k, v in live.items()}
        new_state = TrainState(like(state.params, saved['params']),
                               like(state.momentum, saved['momentum']),
                               int(saved['step']))
        return new_state, np.asarray(saved['key'], np.uint32), side['iter']

    # --------------------------------------------------------- train ----

    def _barrier(self):
        if M.world_size() > 1:
            torch.distributed.barrier()

    def _agree(self, value):
        """Rank 0's value (a bool or int decided on the host) on every
        rank; the value itself without a process group."""
        return M.agree(value, self.device) if M.world_size() > 1 else value

    def _prep_batch(self, key, batch) -> dict:
        """The loader's numpy batch on the device (under a mesh, this
        rank's rows of it): noise (masked when an image does not fill the
        bucket), mean subtraction, a zero pad."""
        b = batch['image'].shape[0]
        hw = batch['im_info'][:, :2].astype(np.int64)
        padded = bool((hw != batch['image'].shape[1:3]).any())
        keys = None
        if padded or self.mesh is not None:
            keys = prng.fold_in(key, np.arange(b))
        if self.mesh is not None:
            batch, keys, hw = M.shard_batch(self.mesh, (batch, keys, hw))
        imgs = to_device(batch['image'], self.device)
        if padded:
            noisy = self._noise_fn.masked(keys, imgs, hw)
        elif keys is not None:
            noisy = self._noise_fn.keyed(keys, imgs)
        else:
            noisy = self._noise_fn(key, imgs)
        out = noisy - self._means
        if padded:
            # the reference's blob pad is zero after mean subtraction
            for i, (h, w) in enumerate(hw):
                out[i, h:] = 0.0
                out[i, :, w:] = 0.0
        return {'image': out, **{k: to_device(batch[k], self.device)
                                 for k in ('im_info', 'gt_boxes', 'gt_mask')}}

    def _log_gt_image_summary(self, batch, it: int):
        """The first image with its gt boxes as an image summary: pixel
        means added back, the bucket pad cropped, BGR -> RGB, the boxes
        drawn by `utils.visualization.draw_bounding_boxes` (class-coloured
        outlines and labels), as the JAX solver draws them."""
        if not self.logger.active_sinks:
            return
        from tpudenoise_torch.utils.visualization import draw_bounding_boxes
        img = (batch['image'][0].cpu().numpy()
               + np.asarray(self.cfg.PIXEL_MEANS, np.float32).reshape(3))
        h, w = (int(v) for v in batch['im_info'][0, :2].tolist())
        gt = batch['gt_boxes'][0][batch['gt_mask'][0]].cpu().numpy()
        self.logger.log_image('train/gt_image',
                              draw_bounding_boxes(img[:h, :w, ::-1], gt),
                              step=it)

    def _log_histogram_summaries(self, state, batch, it: int):
        """TRAIN/ histograms of the parameters, SCORE/ of one test-mode
        forward on the first image, ACT/ of its head feature map (with its
        zero fraction)."""
        if not self.logger.active_sinks:
            return
        for name, p in state.params.items():
            self.logger.log_histogram(f'TRAIN/{name}', p.detach().cpu(),
                                      step=it)
        img, info = batch['image'][:1], batch['im_info'][:1]
        out = self.model.forward_test(state.params, img, info)
        for tag in ('rois', 'roi_scores', 'cls_score', 'cls_prob',
                    'bbox_pred'):
            self.logger.log_histogram(f'SCORE/{tag}', out[tag].cpu(),
                                      step=it)
        with torch.no_grad():
            feat = torch.func.functional_call(
                self.model.head, {k[5:]: v for k, v in state.params.items()
                                  if k.startswith('head.')},
                (img.permute(0, 3, 1, 2),)).float().cpu().numpy()
        self.logger.log_histogram('ACT/net_conv/activations', feat, step=it)
        self.logger.log_scalar_quiet('ACT/net_conv/zero_fraction',
                                     float((feat == 0).mean()), step=it)
        self.logger.flush()

    def train_model(self, max_iters: int, resume: bool = True,
                    on_step=None) -> TrainState:
        """Train to max_iters, resuming from the newest snapshot.
        on_step(it, key, k_noise, k_step, batch, losses), when given, sees
        every iteration (the keys and the raw numpy batch) after its
        step."""
        C = self.cfg
        loader = RoiDataLoader(self.roidb, self.imdb.num_classes, C,
                               batch_size=self.batch_size,
                               bucket=self.bucket, max_gt=self.max_gt)
        if self.prefetch:
            from tpudenoise_torch.data.prefetch import PrefetchLoader
            loader = PrefetchLoader(loader)
        val_loader = RoiDataLoader(self.valroidb, self.imdb.num_classes,
                                   C, random_seed=self._agree(
                                       int(time.time()) % 2**31),
                                   batch_size=self.batch_size,
                                   bucket=self.bucket, max_gt=self.max_gt)
        key = prng.PRNGKey(C.RNG_SEED)
        state = self._init_state_fn(
            torch.Generator().manual_seed(C.RNG_SEED), self.bucket)
        state = TrainState({k: v.to(self.device)
                            for k, v in state.params.items()},
                           {k: v.to(self.device)
                            for k, v in state.momentum.items()}, state.step)
        start = 0
        if resume:
            self._barrier()
            last = self.find_previous()
            if last > 0:
                print(f'Restoring from iteration {last}')
                state, key, start = self.restore(state, loader, val_loader,
                                                 last)
        if self.mesh is not None:
            # rank 0's parameters and momentum on every rank
            M.replicated(self.mesh, (state.params, state.momentum))
        timer = Timer()
        last_summary = time.time()
        try:
            for it in range(start + 1, max_iters + 1):
                timer.tic()
                key, k_noise, k_step = prng.split(key, 3)
                raw = loader.forward()
                batch = self._prep_batch(k_noise, raw)
                state, losses = self._step_fn(state, k_step, batch)
                timer.toc()
                if on_step is not None:
                    on_step(it, key, k_noise, k_step, raw, losses)
                if it % C.TRAIN.DISPLAY == 0:
                    vals = {k: float(v) for k, v in losses.items()}
                    self.logger.log(vals, step=it)
                    print(f'iter: {it} / {max_iters}, '
                          f'total loss: {vals["total_loss"]:.6f} '
                          f'({timer.average_time:.3f}s/iter)')
                    if not np.isfinite(vals['total_loss']) and C.TRAIN.get(
                            'NAN_ABORT', True):
                        raise FloatingPointError(
                            f'non-finite loss at iter {it}: {vals} — '
                            f'aborting (set TRAIN.NAN_ABORT False to '
                            f'ignore)')
                if self._agree(time.time() - last_summary
                               > C.TRAIN.SUMMARY_INTERVAL):
                    self._log_gt_image_summary(batch, it)
                    self._log_histogram_summaries(state, batch, it)
                    if self.valroidb:
                        key, k_vn, k_vs = prng.split(key, 3)
                        vbatch = self._prep_batch(k_vn, val_loader.forward())
                        _, vlosses = self._step_fn(state, k_vs, vbatch,
                                                   update=False)
                        self.logger.log({'val_' + k: float(v)
                                         for k, v in vlosses.items()},
                                        step=it)
                    last_summary = time.time()
                if it % C.TRAIN.SNAPSHOT_ITERS == 0:
                    self.snapshot(state, key, loader, val_loader, it)
                    if self.writer:
                        self.remove_old_snapshots()
                    self._barrier()
            if max_iters % C.TRAIN.SNAPSHOT_ITERS != 0:
                self.snapshot(state, key, loader, val_loader, max_iters)
                self._barrier()
        finally:
            if self.prefetch:
                loader.close()
        return state


def train_net(model, imdb_obj, roidb, valroidb, output_dir, tb_dir,
              pretrained_params=None, max_iters: int = 40000,
              noise: str = 'original', config=None, batch_size: int = 1,
              bucket=None, prefetch: bool = False,
              device='cuda', fast_rng: bool = False) -> TrainState:
    """Filter the roidbs, build the solver (with a pretrained tree merged
    over the seeded init: `models.convert.merge_pretrained`) and train."""
    from tpudenoise_torch.data.roidb import filter_roidb
    roidb = filter_roidb(roidb, config)
    valroidb = filter_roidb(valroidb, config) if valroidb else []
    solver = Solver(model, imdb_obj, roidb, valroidb, output_dir, tb_dir,
                    noise=noise, config=config, batch_size=batch_size,
                    bucket=bucket, prefetch=prefetch,
                    device=device, fast_rng=fast_rng)
    if pretrained_params is not None:
        from tpudenoise_torch.models.convert import merge_pretrained
        init = solver._init_state_fn

        def init_with_pretrained(generator, image_shape):
            st = init(generator, image_shape)
            return TrainState(merge_pretrained(st.params, pretrained_params),
                              st.momentum, st.step)

        solver._init_state_fn = init_with_pretrained
    print('Solving...')
    state = solver.train_model(max_iters)
    print('done solving')
    return state
