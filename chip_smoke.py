"""Drive the PyTorch/CUDA port's eval chunk and training on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without a GPU):
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off;
  2. build: nvcc builds the eight kernel sources of tpudenoise_torch/csrc
     (fourteen kernels and the hash stream), one nvcc process each, all at
     once;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes, each timed beside its plain version:
     sap+median (8, 600, 1000, 3) bit-exact on u8 and on f32 values that
     are not integers, with two medians and with one; gaussian+blur same
     shape
     within max |diff| <= 1 on <= 1e-3 of the pixels; packed NMS masks
     (kernel 3) word for word on 8 x 6144 sorted boxes and on the
     postprocess batch (160 x 320 with invalid rows); the greedy walk
     over the words, keep positions bit-exact, on 8 x 6144 with
     max_outputs 300 and 6144 and on the postprocess batch (ties) with
     100, each timed; mix noise and mix + bilateral on
     16 images of 600x1000 whose explicit branches cover all 13 kinds
     (levels from the var_all table; quant palettes and bloom params from
     the port's prologue; the poisson image dark in its left half, so
     both of its samplers run), bit-exact for original, sap, shader, quant,
     bloom, periodic and brownian, and within a mod-256 distance of 1 on
     <= 1e-3 of the elements for the kinds that go through log/exp/cos
     (gaussian's [0, 1] floats within 1e-6); mix + bilateral also timed
     on 8 images of each kind alone and on 8 images drawn by
     noise_mix_var_all_bilateral's plan (with that plan's bound); bloom
     on 8 images, u8 and f32, bit for bit, each timed; the standalone
     bilateral (8, 600, 1000, 3) f32 bit-exact on u8 values (its table
     form) and on [0, 1] floats (its per-tap expf form), each timed; the
     per-image sap + median entry on the same shape bit-exact (integer
     values and non-integers); the
     threefry fields for 8 keys x 1.8M elements: bits and uniforms
     bit-exact, normals within 2 ulp, and poisson's PTRS draw (64 keys x
     1.8M uniforms) bit-exact, each mode timed with its bound; the
     hash-stream kernel (`--fast-rng`) for 8 seed pairs x 1.8M elements,
     words and uniforms bit-exact, normals within 2 ulp, each mode timed
     with its bound; the
     stage-cut sap + median kernels (the profiling forks) on the
     edge-padded raster of (8, 600, 1000, 3) f32 and u8 images, every
     stage, and the full stage on a random raster, bit-exact, and again
     at the profiling scripts' size (B=128), where each is timed; the
     wavelet denoiser (torch f32 matmuls, not a kernel: a line of its
     own) on (8, 600, 1000, 3) unit floats with and without per-image
     valid extents, card against CPU within 2e-5 and its u8 cast within
     a mod-256 distance of 1 on <= 1e-3 of the elements, timed, its bound
     the banded matmuls' operations over 67 T/s;
  4. correctness of the whole chunk on a small input: the card's
     detect_chunk (f32) against the same chunk run on the CPU through the
     plain versions, for sap, gauss, noise_mix_var_all_bilateral,
     speckle_bilateral_var1.0, uniform_mean_var0.6, quant_var10,
     gaussian_wavelet_var0.1 and noise_mix_var_all_wavelet (>= 95% of
     the CPU's detections with a card twin), and the sap chunk with a
     seeded res50;
  5. main path: detect_chunk with a seeded-init vgg16 VOC-21 Faster R-CNN
     in bf16 on (8, 600, 1000, 3) u8 frames, bucket (608, 1024), for
     sap_median_var0.4, gaussian_gaus_blur_var0.1,
     noise_mix_var_all_bilateral, noise_mix_var_all, bloom,
     speckle_bilateral_var1.0, poisson, gaussian_wavelet_var0.1 and
     noise_mix_var_all_wavelet; 3 warm + 5 timed chunks each,
     chunk i holding images 8i..8i+7 (so each chunk draws its own noise
     and, for the mixes, its own kinds); the launch counters are zeroed
     before each path and read after it, and the path's kernels must have
     launched, kernel 3 and the walk exactly twice a chunk each (the RPN
     NMS and the postprocess NMS); then the per-image sap + median entry's
     own path on the
     sap chunk's images and seeds, equal to the batched kernel's result;
     then the same chunk with a seeded-init ResNet-101 (bench_config6's
     model) for sap_median_var0.4; then the profiling path: the two
     profiling entry points (`profile_sap_breakdown.run` / `u8_run` and
     `profile_fused.kernel_only_output`) once each at B=128, each equal
     to its plain version; then the dataset loop: `test_net_batched` over
     16 numpy-written rrData images of 600x1000 (`.npy` pixels) with a
     seeded two-class vgg16 through the port's rrData and voc_eval: 10
     finite APs in [0, 1], chunk 0 equal to detect_chunk +
     limit_per_image (phase 4's tolerance), the ground truth scoring 1.0,
     and the loop's wall time;
     then the CLIs, in process, with no profiler: `cli.test.main` with a
     seeded res101 (full width and depth, rrData's two classes) written
     as `.npz` by `save_params_npz`, experiments/cfgs/res101.yml,
     --eval-batch 8, over 16 numpy-written 600x1000 images whose `.npy`
     pixels lie where `get_imdb` looks: 10 finite APs, chunk 0 as
     detect_chunk + limit_per_image, kernel 1 once and kernel 3 and the
     walk twice a chunk; `cli.demo.main` with the same weights on
     gaussian_gaus_blur_var0.1 over four numpy images, three 375x500 and
     one 500x375 (scale 1.6, two buckets): the sheet (PPM) written,
     kernel 2 once and kernel 3 and the walk twice an image, the
     portrait image's detections as detect_chunk's; every launch of both
     CLIs held to its plain version on its own inputs (kernel 2 at
     375x500 and 500x375, kernel 3 and the walk at B = 1 and on the
     two-class postprocess batches); each CLI's wall time and img/s, the
     demo's weight load and per-image times;
  5b. training (after the CLIs): `cli.trainval.main` in process, as a
     user calls it, on 16 numpy-written 600x1000 rrData trainval images
     (`.npy` pixels, flips), bucket (608, 1024), batch 1: a seeded res101
     (full width and depth) on sap_median_var0.4, 6 iterations with a
     snapshot every 3, then a second call with --iters 8 that resumes
     from 6 (the restored state equal to the saved one bit for bit, and
     iterations 1-8 seeing the keys and batches of an uninterrupted run);
     vgg16 3 iterations on gaussian_gaus_blur_var0.1 (dropout); one res101
     step each on bloom, speckle_bilateral_var1.0 and
     gaussian_wavelet_var0.1 (the masked generic and bilateral routes,
     the wavelet's statistics over each image's valid region).  Each call: finite losses, kernel 3 and the
     walk once a step at 12000 -> 2000 boxes, the noise string's kernels
     and the threefry draws (8 a step, 10 with vgg16's dropout) launched
     as expected, every launch held to its plain version on its own
     inputs (threefry normals within 2 ulp, kernel 2 within its bound,
     the rest bit-exact); kernel 3 and the walk timed at that size.  Step
     1 with an f32 res101 on the card against the plain versions on the
     CPU (RPN terms within 1e-3 relative, RoI terms within 2e-2: they
     depend on the sampled proposals).  The bf16 res101 step timed: 2
     warm and 5 timed steps split by CUDA events (noise, forward + loss,
     backward, optimizer), the peak memory, and one step under
     set_sync_debug_mode('warn') listing where it waits on the device;
  5c. the noise grid (after training): `experiments.noise_grid.main` in
     process with a seeded res101 (full width and depth), the fixture at
     16 train / 8 test images of 240x320 (seed 3), 20 iterations with a
     snapshot every 10, all 41 GRID strings and the three control rows,
     under build/chip_smoke_grid: finite APs in [0, 1] in every row, the
     three gaus_blur rows equal, each row's route launching its noise
     kernels and no others and kernel 3 and the walk twice a chunk, every
     launch held to its plain version; a second call trains no step; then
     `cli.reval.main` on two rows' output dirs: the row's APs exactly
     without --nms, finite ones with it (its NMS launches held to their
     plain versions); training, sweep and per-row seconds logged;
  5d. evaluation on datasets of many image shapes (after the grid):
     first one small chunk of each new route, card against CPU (two
     images of 160x200 and 200x160, seeded vgg16 f32: sap, brownian and
     bloom on canvases, noise_mix_var_all_bilateral under the pyramid,
     test_net on periodic, COCO's gaussian + blur; phase 4's
     tolerance); then a seeded res101 (bf16, full width and depth),
     eval batch 8, TEST scale 600 and MAX_SIZE 1000, detection buckets
     608x1024 and 1024x608, the noise in per-orientation buckets:
     test_net_batched over a numpy-written voc_2007_test of 32 images
     cycling VOC's shapes (375x500, 500x375, 333x500, 500x333, 366x500,
     500x400) on sap_median_var0.4 (kernel 1 on canvases),
     brownian_var0.09 and periodic_var100 (rasters of each valid
     extent), noise_mix_var_all (the mix scan: threefry, quant) and
     noise_mix_var_all_bilateral (the scan, then kernel 5) and bloom
     (kernel 8); over a coco_2014_minival of 24 images cycling COCO's
     shapes (480x640, 640x480, 427x640, 640x427, 612x612, 375x500) on
     gaussian_gaus_blur_var0.1 (kernel 2) and original, 81 classes; the
     VOC set on original with TEST.SCALES (480, 600) (the pyramid);
     test_net on four VOC images against test_net_batched on the same
     four (phase 4's tolerance); one res101 training step on the VOC
     trainval set with noise_mix_var_all (its batch through the masked
     mix scan; finite losses).  Each run: counters zeroed before and
     read after, the route's kernels launched, kernel 3 and the walk
     once a forward and once a chunk, every launch held to its plain
     version, finite APs (COCO: 12 finite stats); images, buckets,
     chunks, seconds and img/s logged, and after the timed runs each
     run's first chunk profiled for the device's idle share (one
     session, the device's activity only, marker kernels between the
     runs); kernel 3
     and the walk timed at the pyramid's and COCO's postprocess shapes;
  5e. the last single-card options (run after phase 6 and the
     kernels' device-time reads, before 5g: run before those reads, its
     curvelet chunks left torch.profiler dropping kernel records in
     them), seeded
     res101 bf16 at
     full width and depth, batch 8, raw 600x1000, bucket 608x1024:
     `--fast-rng` on poisson, gamma_var0.3, brownian_var0.09 and
     speckle_bilateral_var1.0, 3 warm and 5 timed chunks each with and
     without the flag (img/s and noise ms of both logged; with it the
     hash kernel's launches as the salts imply a chunk and no threefry
     draw), one more chunk of each with every hash launch held to its
     plain version, and sap_median_var0.4 giving the same bytes with the
     flag; one `cli.trainval --fast-rng` step (res101, poisson, the
     training phase's images: finite losses, hash launches held to their
     plain version); the `curvelet` string through detect_chunk (kernel
     6, then the curvelet post-pass on torch.fft), 3 chunks, the
     post-pass timed by CUDA events and each chunk's peak memory logged,
     then two 160x200 images card against CPU; `cli.fdct` on a 600x1000
     `.npy` image; `cli.test --compute-id` (res101 with a randomized
     head: the seeded conv3 is zero) over the CLI phase's 16 images, its
     loop timed against the same command without the probes, every
     logged TwoNN ID finite and positive;
  5f. the last backbone and the last offline tools (after 5c, before
     5d: 5d's profiler sessions are the process's first, and after a
     session a run of unprofiled work as long as 5f's left
     torch.profiler dropping kernel records in phase 6's reads): a
     seeded mobile (bf16, DEPTH_MULTIPLIER
     1.0, all 14 layers) on the main path, batch 8, raw 600x1000, bucket
     608x1024, for sap_median_var0.4 (kernel 1) and
     gaussian_gaus_blur_var0.1 (kernel 2), 3 warm and 5 timed chunks each
     (img/s median, min and max; noise and forward ms by CUDA events),
     every launch (kernel 3 and the walk twice a chunk) held to its plain
     version; the head's time on the bucket split into the depthwise,
     pointwise and full convs and BN + ReLU6; one small chunk (f32, BN
     randomized) card against CPU in two parts: the forward outputs
     within stated bounds, and the CPU postprocess of the card's forward
     keeping the card's detections (phase 4's twin share logged); one
     `cli.trainval --net mobile` step on the training phase's images
     (finite losses, the frozen parameters bit-equal after it, others
     moved, every launch held to its plain version), then the bf16 step
     timed by CUDA events; `cli.test --net mobile --compute-id` over the
     CLI phase's 16 images (every TwoNN ID finite and positive);
     `cli.convert` on a torchvision-layout res101 `.pth` of seeded random
     tensors, then `cli.test --model` on the `.npz` printing `Loaded
     n/N`; the Automold suite: `augment_random` with each name of
     AUG_TYPES forced on 8 images of 600x1000 (ms per image), each
     `add_sun_flare` launch of kernel 8 held to its plain version, and
     every name on two 120x160 images card against CPU;
  5h. the TensorFlow sources and the XLA route (after 5f, before 5d's
     profiler sessions): the port's checkpoint writer writes a seeded
     full-width resnet_v1_101 under the slim ImageNet scopes and a res101
     detector under the reference's scopes (21 classes, a global_step) as
     V2 checkpoints; `cli.convert` turns each into a `.npz` through the
     numpy reader (host seconds and MB/s), the trees equal to the written
     arrays bit for bit (conv1 flipped to BGR in the ImageNet one only);
     `cli.trainval --weight` on the ImageNet `.npz`, 2 iterations on the
     training phase's images (`Loaded n/N`, finite losses, every launch
     held to its plain version); `cli.test --model` with the detector
     over 16 numpy-written VOC images of 600x1000 (its 21 classes) on
     sap_median_var0.4, batch 8 (kernel 1 once and kernel 3 and the walk
     twice a chunk, every launch held to its plain version), its
     detections bit-equal to those of the same command with the arrays
     saved directly by save_tree_npz; then `make_pipeline(...,
     use_kernels=False)` on one res101 chunk of 8 for sap_median_var0.4,
     gaussian_gaus_blur_var0.1, noise_mix_var_all and
     noise_mix_var_all_bilateral, fast_rng off and on: the route's draws
     (threefry, or the hash kernel) and kernel 5 launched and no fused
     kernel, every launch held to its plain version, finite detections,
     the keyed noise held to the same route on the CPU (sap bit-exact,
     the others within a mod-256 distance of 1 on <= 1e-3 of the
     elements; the bilateral post-pass as kernel 5's plain version of the
     plain mix's output), and the noise stage's ms by CUDA events beside
     the default route's;
  5i. the last gaps of the JAX package (after 5h, before 5d's profiler
     sessions; ~25 s): a seeded res101's proposals (forward_test, 300 an
     image) on the dataset phase's 16 images written as the `rpn_file`
     pickle; `evaluate_recall` with the IoU on the card and on the CPU
     (the same ar, recalls and matched overlaps); an `rpn` training
     roidb (trainval over the same images, flips) built with the IoU on
     the card and on the CPU (the same rows, `filter_roidb` keeping the
     same images), then `train_net` 2 iterations on the card (finite
     losses, only gt rows in a batch); `tpudenoise_torch/examples/
     smoke.py`'s main() in process; `test_faster_rcnn.sh 0 rrData res101
     sap_median_var0.4` run for real in build/chip_smoke_scripts on 5h's
     2-iteration `cli.trainval` snapshot placed at `..._iter_5000` (its
     own process), its detections bit-equal to a direct `cli.test` with
     the same arguments; `cli.reval --nms` on those detections on the
     card and on the CPU with `USE_NATIVE_NMS` set and unset (the same
     kept boxes; the three NMS routes timed); `train_faster_rcnn.sh` on
     its NET_FINAL skip; `convert_vgg16.sh` on a seeded full-width vgg16
     V2 checkpoint that another process writes, its `.npz` bit-equal to
     a direct `cli.convert` (run in this process while the drivers run).
     Every launch in this process (kernels 1, 3 and the walk) is counted
     and held to its plain version; the drivers' processes are held
     through their outputs, equal to the direct calls';
  6. where the time goes: one chunk of each string under torch.profiler,
     the device's activity only (device kernel time, idle share, the
     port's own kernels' share, split by kernel name with their launches:
     the threefry draws' device time a chunk gets a line of its own), and
     of the res101 sap chunk and the mobile chunks; then `cli.demo` again
     under --profile (sheet, trace file and launches as
     without it; the profiler's start, the profiled block and the trace
     export timed apart); then two training steps under torch.profiler
     (the step's idle share); then each kernel's device time on phase
     3's inputs;
  5g. data parallelism (last; its ranks are processes of their own,
     `python3 chip_smoke.py --rank SPEC`, in torchrun's environment):
     references in this process, `cli.trainval` res101 on the training
     phase's images, 3 iterations at --batch 1 (bf16) and --batch 2
     (f32 with f32 class heads), and `cli.test --eval-batch 8` over the
     CLI phase's 16 images; then a world of one over NCCL and a world of
     two sharing the card over gloo, each rank running the spatial
     median, mean and gaussian on (8, 600, 1000, 3), H split over the
     ranks and gathered bit-equal to the stencils (both timed), one
     all-reduce of res101's trainable gradients (timed), `cli.test
     --distributed` (a warm call, then a timed one) and `cli.trainval
     --distributed --batch <ranks>`, every launch held to its plain
     version.  World 1 bit-equal to the reference without
     --distributed (losses and parameters); world 2's step-1 losses and
     later RPN losses within 1e-4 of the --batch 2 reference's (its
     later RoI terms logged: DP_LOSS_RTOL), its frozen parameters
     bit-equal and both ranks' parameters bit-equal; each world's detections
     matching the reference's at phase 4's tolerance.  Two ranks on one
     card check correctness, not scaling.
Each kernel's row carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over 67 T/s (the card's non-tensor f32
rate; integer and transcendental operations counted one each, from the
plain version's per-element operations).  Its ms is by CUDA events over
back-to-back launches in phase 3 (host time between them included);
device_ms is the kernel time of as many launches from torch.profiler,
read in phase 6 so that no profiler session runs before the timed chunks.
The line before the last is the card's name and power limit, the one
before that the kernel table as JSON; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.benchmarks import profile_bilateral as pb
from tpudenoise_torch.benchmarks import profile_fused as pf
from tpudenoise_torch.benchmarks import profile_sap_breakdown as psb
from tpudenoise_torch.benchmarks.profile_bilateral import (MIX_ENTRIES,
                                                            MIX_PLAN)
from tpudenoise_torch.benchmarks.timing import (MARKER, card_line, device_ms,
                                              time_ms)
from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import default_config, get_output_dir
from tpudenoise_torch.data import synthetic
from tpudenoise_torch.data.voc_like import rrData
from tpudenoise_torch.denoise import bilateral as bil
from tpudenoise_torch.denoise import stencils
from tpudenoise_torch.eval.harness import (detect_chunk, limit_per_image,
                                           noise_chunk, set_matmul_precision,
                                           test_net_batched)
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.noise import bloom as bl
from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise import pipeline
from tpudenoise_torch.noise.generators import bloom_apply_scan, bloom_params
from tpudenoise_torch.noise.mix_prologue import (entry_draws, fixed_prologue,
                                                 plan_tables)
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import Kind, parse
from tpudenoise_torch.ops import nms
from tpudenoise_torch.utils.blob import derive_bucket, rescale_geometry
from tpudenoise_torch.utils.image_io import read_bgr

B, H, W = 8, 600, 1000
BUCKET = (608, 1024)
NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
          'noise_mix_var_all_bilateral', 'noise_mix_var_all', 'bloom',
          'speckle_bilateral_var1.0', 'poisson', 'gaussian_wavelet_var0.1',
          'noise_mix_var_all_wavelet')
SMALL_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
                'noise_mix_var_all_bilateral', 'speckle_bilateral_var1.0',
                'uniform_mean_var0.6', 'quant_var10',
                'gaussian_wavelet_var0.1', 'noise_mix_var_all_wavelet')
# the wavelet line: floats card vs CPU (the decomposition's budget) and
# the u8 cast's mod-256 distance 1 on at most this share of the elements
WAVELET_TOL = 2e-5
WAVELET_U8_SHARE = 1e-3
DEV = 'cuda'
MASKS, WALK = 'build_suppression_masks_cuda', 'greedy_keep'
# no Pallas counterpart: the reference's nms_packed sweeps to a fixpoint
WALK_REPLACES = 'tpudenoise/ops/nms.py:365'
SOURCES = ('fused_noise', 'nms_mask', 'mix_noise', 'bloom', 'bilateral',
           'threefry', 'sap_stages', 'hash_stream')
# the dataset-loop phase: images and noise string
LOOP_IMAGES, LOOP_NOISE = 16, 'sap_median_var0.4'
# the CLI phase: images of the eval CLI, the demo's image shapes and noise
CLI_IMAGES = 16
DEMO_SHAPES = ((375, 500),) * 3 + ((500, 375),)
DEMO_NOISE = 'gaussian_gaus_blur_var0.1'
# the res101 main path: bench_config6's model and noise
RES_NOISES = ('sap_median_var0.4',)
# the stage-cut kernels' symbols: the copy/noise kernel and the walk
SAP_STAGES = ('sap_stages_',)
# the profiling scripts' batch and the tile heights their rows are timed at
PROFILE_B = 128
PROFILE_TILES = {'sap_stages_f32': 56, 'sap_stages_u8': 120,
                 'sap_full_padded': 56}
# poisson's PTRS draw: B images x 4 rounds x (u, v) fields
PTRS_KEYS = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
# operations per element (one of B*H*W*3), counted from each plain
# version, a transcendental as one: hash 15, compare/select 4, a 3x3
# median pass 16, a [1,2,1] blur pass 12, Box-Muller 12, the 49-tap
# bilateral 312 (937 per pixel), a 48-step bloom composite 430, a
# threefry word 78 (+4 for a uniform, +22 for erf_inv), a counter-hash
# word 11 (+3 for a uniform; a normal two words, two uniforms, log, sqrt,
# cos and 3 multiplies: 35)
OPS = {'sap_median': 15 + 4 + 2 * 16, 'gauss_blur': 2 * 15 + 12 + 6 + 2 * 12,
       'bilateral': 312, 'bloom': 430, 'bits': 78, 'uniform': 82,
       'normal': 104, 'hash_bits': 11, 'hash_u01': 14, 'hash_normal': 35}
# the stage-cut sap + median kernel, per output element
STAGE_OPS = {'copy': 0, 'noise': 15 + 4, 'med1': 15 + 4 + 16,
             'full': OPS['sap_median']}
# mix kernels, by kind (Kind value): the kind's generator per element
MIX_OPS = {0: 0, 1: 45, 2: 330, 3: 20, 4: 47, 5: 110, 6: 22, 7: 60, 8: 8,
           9: 300, 10: 25, 11: 430, 12: 6}
# kinds through logf/expf/cosf: gaussian, poisson, speckle, uniform,
# gamma, rayleigh (their bound is stated; the rest must be bit-exact)
TRANSCENDENTAL = {1, 2, 4, 6, 9, 10}


def log(*a):
    print(*a, flush=True)


# each backbone's class-independent seeded init, drawn once: vgg16's
# truncated normals take seconds of host time, and several phases build
# the same seeded backbone
_SEEDED = {}


def seeded(model) -> dict:
    """model.init(torch.Generator().manual_seed(0)), bit for bit, on a
    model still on the CPU.  init draws the head, the RPN and the tail,
    then the class heads (`rcnn`); the first three and the generator's
    state after them are drawn once per backbone and copied."""
    parts = ('head', 'rpn', 'tail')
    key = (model.backbone,) + tuple(
        (k, tuple(v.shape)) for n in parts
        for k, v in getattr(model, n).state_dict().items())
    g = torch.Generator().manual_seed(0)
    if key not in _SEEDED:
        for n in parts:
            getattr(model, n).reset_parameters(g)
        _SEEDED[key] = ({n: copy.deepcopy(getattr(model, n).state_dict())
                         for n in parts}, g.get_state())
    else:
        states, state = _SEEDED[key]
        for n in parts:
            getattr(model, n).load_state_dict(states[n])
        g.set_state(state)
    model.rcnn.reset_parameters(g)
    return model.state_dict()


def later(*args, **kw):
    """device_ms(*args, **kw), read only after the main paths (main):
    a torch.profiler session before them would run in their timed
    chunks."""
    return functools.partial(device_ms, *args, **kw)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the non-tensor rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                # no single PyTorch call computes any of these functions
                library_ms=None)


def near_threshold_pairs(rng, k: int, t: float = 0.7):
    """k box pairs (A, A shifted right by dx) whose f32 IoU, evaluated in
    the reference's operation order, lies at or one ulp beside f32(t):
    dx is nudged by f32 ulps onto the boundary, then a third of the pairs
    step one ulp left and a third one ulp right.  Returns two (k, 4)
    arrays."""
    f, t32 = np.float32, np.float32(t)
    x, y = rng.uniform(0, 300, (2, k)).astype(f)
    w, h = rng.uniform(20, 200, (2, k)).astype(f)
    a = np.stack([x, y, x + w, y + h], 1)

    def shifted(dx):
        return np.stack([x + dx, y, x + dx + w, y + h], 1)

    def iou(b):
        ba = (a[:, 2] - a[:, 0] + f(1)) * (a[:, 3] - a[:, 1] + f(1))
        area = (b[:, 2] - b[:, 0] + f(1)) * (b[:, 3] - b[:, 1] + f(1))
        iw = np.maximum(f(0), np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]) + f(1))
        ih = np.maximum(f(0), np.minimum(a[:, 3], b[:, 3])
                        - np.maximum(a[:, 1], b[:, 1]) + f(1))
        inter = iw * ih
        return inter / ((ba + area) - inter)

    dx = ((w + 1) * f((1 - t) / (1 + t))).astype(f)
    for _ in range(64):
        v = iou(shifted(dx))
        dx = np.where(v == t32, dx, np.nextafter(
            dx, np.where(v > t32, f(np.inf), f(-np.inf)))).astype(f)
    step = rng.randint(-1, 2, k)
    dx = np.where(step == 0, dx, np.nextafter(
        dx, np.where(step > 0, f(np.inf), f(-np.inf)))).astype(f)
    return a, shifted(dx)


def nms_boxes(rng, b: int, n: int) -> np.ndarray:
    """(b, n, 4) score-sorted proposal-like boxes with exact duplicates,
    pairs at IoU exactly 0.7 (a 10x10 box and its 10x7 top part) and
    pairs within an f32 ulp of IoU 0.7 (any change to the order of the
    IoU arithmetic flips some of their bits)."""
    out = np.empty((b, n, 4), np.float32)
    for i in range(b):
        xy = rng.uniform(0, [W - 32, H - 32], (n, 2))
        wh = rng.uniform(8, 300, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], 1)
        dup = rng.choice(n, n // 8, replace=False)
        boxes[dup[1:]] = boxes[dup[:-1]]
        for k in rng.choice(n - 1, n // 16, replace=False):
            x, y = np.floor(rng.uniform(0, 900, 2))
            boxes[k] = (x, y, x + 9, y + 9)
            boxes[k + 1] = (x, y, x + 9, y + 6)
        a, c = near_threshold_pairs(rng, n // 16)
        boxes[n // 2::8], boxes[n // 2 + 1::8] = a, c
        out[i] = boxes
    return out


def postprocess_boxes(rng):
    """The postprocess NMS's batch: B images x 20 classes = 160 problems
    of 300 RoIs padded to 320, score-sorted, boxes on a coarse grid (ties
    and long suppression chains), a quarter of the RoIs and the 20 pad
    rows invalid and zero.  Returns (160, 320, 4) f32 boxes and the
    (160, 320) validity on the card."""
    p, r, n = B * 20, 300, 320
    xy = rng.uniform(0, 120, (p, n, 2))
    bx = np.round(np.concatenate([xy, xy + rng.uniform(8, 200, (p, n, 2))],
                                 -1) / 8) * 8
    valid = rng.uniform(size=(p, n)) > 0.25
    valid[:, r:] = False
    bx[~valid] = 0.0
    return (torch.from_numpy(bx.astype(np.float32)).to(DEV),
            torch.from_numpy(valid).to(DEV))


def mask_bound(boxes, words) -> dict:
    """Kernel 3's bound: ~15 operations for each pair i < j, N(N-1)/2 a
    problem; the boxes read and the words written."""
    p, n, _ = boxes.shape
    return bound(boxes.numel() * 4 + words.numel() * 4,
                 15 * p * n * (n - 1) // 2)


def walk_bound(words, keep, max_out) -> dict:
    """The walk's bound: the words it must read.  Per problem, each strip
    up to the one where the max_out-th box is kept (or the last) that
    keeps a box reads its row's words from the strip's own columns on."""
    p, nw, n = words.shape
    kept = keep.long().cpu().numpy()
    nbytes = 0
    for row in kept:
        pos = row[row >= 0]
        last = pos[max_out - 1] // 32 if len(pos) >= max_out else nw - 1
        strips = np.unique(pos // 32)
        nbytes += 4 * sum(n - 32 * s for s in strips if s <= last)
    return bound(nbytes, 0)


def check_greedy(boxes, masks, post_valid) -> dict:
    """The walk kernel bit-exact against its plain version: the RPN's 8 x
    6144 words with max_outputs 300 (the main path's early stop) and 6144
    (no early stop; ~3% of the boxes invalid), and the postprocess batch
    (160 x 320, ties) with 100; each timed."""
    rng = np.random.RandomState(8)
    valid = torch.from_numpy(rng.uniform(size=boxes.shape[:2]) > 0.03).to(
        DEV)
    cases = {'8 x 6144, 300': (masks['8 x 6144'], valid, 300),
             '8 x 6144, 6144': (masks['8 x 6144'], valid, 6144),
             '160 x 320, 100': (masks['160 x 320'], post_valid, 100)}
    row = dict(name=WALK, route='cuda',
               source='tpudenoise_torch/csrc/nms_mask.cu',
               replaces=WALK_REPLACES, max_abs_err=0.0, cases={})
    for what, (words, v, m) in cases.items():
        got = nms.greedy_keep(words, v, m)
        want = nms.greedy_keep_plain(words, v, m)
        torch.cuda.synchronize()
        bad = (got.long() != want).sum().item()
        kept = (want >= 0).sum(1).float().mean().item()
        log(f'kernel greedy_keep {what}: {bad} of {got.numel()} positions '
            f'differ; {kept:.1f} kept a problem (bit-exact required)')
        if bad or kept == 0:
            raise AssertionError(f'greedy_keep differs from its plain '
                                 f'version at {what}')
        row['cases'][what] = dict(
            ms=time_ms(lambda: nms.greedy_keep(words, v, m), 20),
            # read after the main paths: bind this case's inputs now
            device_ms=later(lambda words=words, v=v, m=m: nms.greedy_keep(
                words, v, m), 20, ('greedy_kernel',)),
            plain_ms=time_ms(lambda: nms.greedy_keep_plain(words, v, m), 2,
                             1),
            kept=kept, **walk_bound(words, want, m))
    row.update({k: v for k, v in row['cases']['8 x 6144, 300'].items()
                if k != 'kept'})
    return row


def check_kernels(dev) -> list:
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.from_numpy(rng.randint(0, 2**31 - 1, B).astype(
        np.int32)).to(dev)
    rows = []

    # kernel 1: bit-exact on u8 (the packed route) and on f32 values that
    # are not integers (the float route), with two medians and with one;
    # the fractions from a stream of their own, so that the later checks'
    # inputs stay as they were
    frac = raw.to(torch.float32) + torch.from_numpy(np.random.RandomState(
        4).uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32)).to(dev)
    err = 0.0
    for what, im in (('u8', raw), ('f32 non-integers', frac)):
        for double in (True, False):
            got = fk.fused_sap_median_batched(im, seeds, 0.4, double)
            want = fk.fused_sap_median_plain(im, seeds, 0.4, double)
            torch.cuda.synchronize()
            e = (got.double() - want.double()).abs().max().item()
            log(f'kernel sap_median {what}, double={double}: max |diff| {e} '
                f'(bit-exact required)')
            if e != 0:
                raise AssertionError(f'sap_median kernel differs from its '
                                     f'plain version on {what}')
            err = max(err, e)
    rows.append(dict(
        name='fused_sap_median_batched', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:389',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median_batched(raw, seeds, 0.4,
                                                       True), 20),
        device_ms=later(lambda: fk.fused_sap_median_batched(
            raw, seeds, 0.4, True), 20, ('sap_median_kernel',)),
        plain_ms=time_ms(lambda: fk.fused_sap_median_plain(raw, seeds, 0.4,
                                                           True), 3, 1),
        **bound(2 * raw.numel(), OPS['sap_median'] * raw.numel())))

    # kernel 2: per-image sigma from the three levels
    lv = np.sqrt(np.asarray([0.1, 1.0, 1.5], np.float32))
    sig = torch.from_numpy(lv[rng.randint(0, 3, B)]).to(dev)
    got = fk.fused_gaussian_blur(raw, seeds, 0.1, True, sigmas=sig)
    want = fk.fused_gaussian_blur_plain(raw, seeds, 0.1, True, sigmas=sig)
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    err = diff.max().item()
    share = (diff.amax(-1) > 0).double().mean().item()
    log(f'kernel gauss_blur: max |diff| {err}, changed pixel share '
        f'{share:.3e} (bound: max 1, share 1e-3)')
    if err > 1 or share > 1e-3:
        raise AssertionError('gauss_blur kernel outside its bound')
    rows.append(dict(
        name='fused_gaussian_blur', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:192',
        max_abs_err=float(err), changed_share=share,
        ms=time_ms(lambda: fk.fused_gaussian_blur(raw, seeds, 0.1, True,
                                                  sigmas=sig), 20),
        device_ms=later(lambda: fk.fused_gaussian_blur(
            raw, seeds, 0.1, True, sigmas=sig), 20, ('gauss_blur_kernel',)),
        plain_ms=time_ms(lambda: fk.fused_gaussian_blur_plain(
            raw, seeds, 0.1, True, sigmas=sig), 3, 1),
        **bound(2 * raw.numel(), OPS['gauss_blur'] * raw.numel())))

    # kernel 3: word for word at the TEST budget (6000 -> 6144) and on the
    # postprocess batch; then the greedy walk over its words
    boxes = torch.from_numpy(nms_boxes(rng, B, 6144)).to(dev)
    post, post_valid = postprocess_boxes(rng)
    masks = {}
    for what, bx, t in (('8 x 6144', boxes, 0.7), ('160 x 320', post, 0.3)):
        got = nms.build_suppression_masks_cuda(bx, t)
        want = nms.build_suppression_masks(bx, t)
        torch.cuda.synchronize()
        bad = (got != want).sum().item()
        log(f'kernel suppression_masks {what}: {bad} of {got.numel()} words '
            f'differ; {int((got != 0).sum())} non-zero words')
        if bad or not got.any():
            raise AssertionError(f'suppression mask kernel differs from its '
                                 f'plain version at {what}')
        masks[what] = got
    got = masks['8 x 6144']
    rows.append(dict(
        name=MASKS, route='cuda',
        source='tpudenoise_torch/csrc/nms_mask.cu',
        replaces='tpudenoise/ops/nms.py:234', max_abs_err=0.0,
        ms=time_ms(lambda: nms.build_suppression_masks_cuda(boxes, 0.7), 20),
        device_ms=later(lambda: nms.build_suppression_masks_cuda(
            boxes, 0.7), 20, ('mask_kernel',)),
        plain_ms=time_ms(lambda: nms.build_suppression_masks(boxes, 0.7),
                         3, 1),
        **mask_bound(boxes, got),
        post_ms=time_ms(lambda: nms.build_suppression_masks_cuda(post, 0.3),
                        20),
        post_device_ms=later(lambda: nms.build_suppression_masks_cuda(
            post, 0.3), 20, ('mask_kernel',)),
        post_plain_ms=time_ms(lambda: nms.build_suppression_masks(post, 0.3),
                              3, 1),
        post_bound_ms=mask_bound(post, masks['160 x 320'])['bound_ms']))
    rows.append(check_greedy(boxes, masks, post_valid))

    # kernel 4: the per-image entry of kernel 1 (f32 I/O), bit-exact on
    # integer values and on values that are not integers
    img = raw.to(torch.float32)
    err = 0.0
    for what, im in (('integers', img), ('non-integers', frac)):
        got = fk.fused_sap_median(im, seeds, 0.4, True)
        torch.cuda.synchronize()
        e = (got - fk.fused_sap_median_plain(im, seeds, 0.4, True)).abs(
        ).max().item()
        log(f'kernel sap_median (per image) on {what}: max |diff| {e} '
            f'(bit-exact required)')
        if e != 0:
            raise AssertionError(f'per-image sap_median differs from its '
                                 f'plain version on {what}')
        err = max(err, e)
    rows.append(dict(
        name='fused_sap_median', route='cuda',
        source='tpudenoise_torch/csrc/fused_noise.cu',
        replaces='tpudenoise/noise/pallas_kernels.py:339',
        max_abs_err=float(err),
        ms=time_ms(lambda: fk.fused_sap_median(img, seeds, 0.4, True), 20),
        device_ms=later(lambda: fk.fused_sap_median(img, seeds, 0.4, True),
                        20, ('sap_median_kernel',), per_call=B),
        plain_ms=time_ms(lambda: fk.fused_sap_median_plain(img, seeds, 0.4,
                                                           True), 3, 1),
        **bound(8 * img.numel(), OPS['sap_median'] * img.numel())))

    # kernel 5: the standalone bilateral, bit-exact, on u8-domain floats
    # with a zero band (as clipped noise makes; the table form) and on
    # [0, 1] floats (the gaussian kind's output; the per-tap expf form)
    band = img.clone()
    band[:, :, :7] = 0.0
    unit = torch.from_numpy(rng.uniform(0.0, 1.0, (B, H, W, 3)).astype(
        np.float32)).to(dev)
    err = 0.0
    for what, x in (('u8 values', band), ('[0, 1] floats', unit)):
        got = bil.bilateral_batched(x)
        torch.cuda.synchronize()
        e = (got - bil.bilateral_plain(x)).abs().max().item()
        log(f'kernel bilateral on {what}: max |diff| {e} (bit-exact '
            f'required)')
        if e != 0:
            raise AssertionError(f'bilateral kernel differs from its plain '
                                 f'version on {what}')
        err = max(err, e)
    rows.append(dict(
        name='bilateral_batched', route='cuda',
        source='tpudenoise_torch/csrc/bilateral.cu',
        replaces='tpudenoise/denoise/pallas_bilateral.py:138',
        max_abs_err=float(err),
        ms=time_ms(lambda: bil.bilateral_batched(band), 20),
        device_ms=later(lambda: bil.bilateral_batched(band), 20,
                        ('bilateral_kernel',)),
        unit_floats_ms=time_ms(lambda: bil.bilateral_batched(unit), 20),
        unit_floats_device_ms=later(
            lambda: bil.bilateral_batched(unit), 20, ('bilateral_kernel',)),
        plain_ms=time_ms(lambda: bil.bilateral_plain(band), 3, 1),
        **bound(8 * band.numel(), OPS['bilateral'] * band.numel())))
    return rows


def check_threefry(dev) -> list:
    """The threefry fields of the main paths against the plain version on
    the card: 8 keys x 1.8M elements (one (8, 600, 1000, 3) field) in all
    three modes, bits and uniforms bit-exact, normals within 2 ulp, and
    poisson's PTRS draw (64 keys x 1.8M uniforms) bit-exact; each timed
    with its bound.  The row's own numbers are the speckle draw's
    (normals)."""
    n = H * W * 3
    keys = torch.from_numpy(prng.split(prng.PRNGKey(11), B).astype(
        np.int64)).to(dev)
    ptrs = torch.from_numpy(prng.split(prng.PRNGKey(12), PTRS_KEYS).astype(
        np.int64)).to(dev)
    scale = float(prng._SQRT2)
    worst = 0
    modes = {}
    for mode, k in (('bits', keys), ('uniform', keys), ('normal', keys),
                    ('uniform', ptrs)):
        got = prng.threefry_draw(k, n, mode, 0.0, 1.0, scale)
        want = prng.threefry_draw_plain(k, n, mode, 0.0, 1.0, scale)
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs()
        m = ulp.max().item()
        what = f'{mode} {k.shape[0]} x {n}'
        log(f'kernel threefry {what}: max {m} ulp, '
            f'{(ulp > 0).double().mean().item():.2e} differ (bound: 0 for '
            f'bits and uniforms, 2 ulp for normals)')
        if m > (2 if mode == 'normal' else 0):
            raise AssertionError(f'threefry {what} outside its bound')
        worst = max(worst, (got - want).abs().max().item()
                    if mode == 'normal' else 0.0)
        del got, want, ulp

        def draw(k=k, mode=mode):
            return prng.threefry_draw(k, n, mode, 0.0, 1.0, scale)

        modes[what] = dict(ms=time_ms(draw, 20),
                           device_ms=later(draw, 20, ('threefry_kernel',)),
                           **bound(4 * k.shape[0] * n,
                                   OPS[mode] * k.shape[0] * n))
    bits_cpu = prng.threefry_draw(keys[:1].cpu(), 4096, 'bits')
    if not torch.equal(bits_cpu, prng.threefry_draw(keys[:1], 4096,
                                                    'bits').cpu()):
        raise AssertionError('threefry bits differ between card and CPU')
    row = modes[f'normal {B} x {n}']
    return [dict(
        name='threefry_draw', route='cuda',
        source='tpudenoise_torch/csrc/threefry.cu',
        replaces='tpudenoise/noise/generators.py:140',
        max_abs_err=worst, ms=row['ms'], device_ms=row['device_ms'],
        plain_ms=time_ms(lambda: prng.threefry_draw_plain(
            keys, n, 'normal', 0.0, 1.0, scale), 3, 1),
        modes=modes, **{k: row[k] for k in ('bound_ms', 'bound_by',
                                             'library_ms')})]


def check_hash(dev) -> list:
    """The hash-stream kernel (`--fast-rng`) against its plain version on
    the card: 8 seed pairs x 1.8M elements (one (8, 600, 1000, 3) field)
    in its three modes, words and uniforms bit-exact, Box-Muller normals
    within 2 ulp (the threefry normals' bound); the words equal the CPU's.
    Each mode timed with its bound; the row's own numbers are the normals
    (gaussian, speckle and brownian draw them)."""
    n = H * W * 3
    seeds = torch.from_numpy(prng.split(prng.PRNGKey(15), B).astype(
        np.int64)).to(dev)
    worst = 0.0
    modes = {}
    for mode in ('bits', 'u01', 'normal'):
        got = prng.hash_draw(seeds, n, 64, mode)
        want = prng.hash_draw_plain(seeds, n, 64, mode)
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs()
        m = ulp.max().item()
        log(f'kernel hash_draw {mode} {B} x {n}: max {m} ulp, '
            f'{(ulp > 0).double().mean().item():.2e} differ (bound: 0 for '
            f'words and uniforms, 2 ulp for normals)')
        if m > (2 if mode == 'normal' else 0):
            raise AssertionError(f'hash_draw {mode} outside its bound')
        if mode == 'normal':
            worst = (got - want).abs().max().item()
        del got, want, ulp

        def draw(mode=mode):
            return prng.hash_draw(seeds, n, 64, mode)

        modes[f'{mode} {B} x {n}'] = dict(
            ms=time_ms(draw, 20),
            device_ms=later(draw, 20, ('hash_kernel',)),
            **bound(4 * B * n, OPS['hash_' + mode] * B * n))
    if not torch.equal(prng.hash_draw(seeds[:2], 4099, 16, 'bits').cpu(),
                       prng.hash_draw_plain(seeds[:2].cpu(), 4099, 16,
                                            'bits')):
        raise AssertionError('hash_draw words differ between card and CPU')
    row = modes[f'normal {B} x {n}']
    return [dict(
        name='hash_draw', route='cuda',
        source='tpudenoise_torch/csrc/hash_stream.cu',
        replaces='tpudenoise/noise/fast_samplers.py:62',
        max_abs_err=worst, ms=row['ms'], device_ms=row['device_ms'],
        plain_ms=time_ms(lambda: prng.hash_draw_plain(seeds, n, 64,
                                                      'normal'), 3, 1),
        modes=modes, **{k: row[k] for k in ('bound_ms', 'bound_by',
                                             'library_ms')})]


def check_sap_stages(dev) -> list:
    """Kernels 9-11, the stage-cut forks of kernel 1, against their plain
    versions at (8, 600, 1000, 3), bit-exact: every stage on the
    edge-padded raster of f32 and u8 images (its full stage, sliced, must
    also equal kernel 1), and the full stage of `sap_full_padded` on a
    random raster whose halo rows and pad lanes hold arbitrary values.
    Then each stage is held bit-exact again and timed at the profiling
    scripts' size (B = 128, the row's tile height); the row's own numbers
    are the full stage's, and the copy stage has one PyTorch call, a
    slice's clone."""
    rng = np.random.RandomState(9)
    w3 = 3 * W
    seeds = torch.from_numpy(rng.randint(0, 2**31 - 1, B).astype(
        np.int32)).to(dev)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    big_raw = torch.from_numpy(rng.randint(0, 256, (PROFILE_B, H, W, 3))
                               .astype(np.uint8)).to(dev)
    big_seeds = torch.arange(PROFILE_B, dtype=torch.int32, device=dev)
    rows = []
    for name, dtype, line in (
            ('sap_stages_f32', torch.float32,
             'benchmarks/profile_sap_breakdown.py:105'),
            ('sap_stages_u8', torch.uint8,
             'benchmarks/profile_sap_breakdown.py:189'),
            ('sap_full_padded', torch.float32,
             'benchmarks/profile_fused.py:48')):
        tile_h = PROFILE_TILES[name]
        _, w3p, hp = psb.raster_geometry(H, W, tile_h)
        if name == 'sap_full_padded':
            small = torch.from_numpy(rng.randint(
                0, 256, (B, hp + 2 * fk.HALO, w3p)).astype(np.float32)
            ).to(dev)
            big = torch.from_numpy(rng.randint(
                0, 256, (PROFILE_B, hp + 2 * fk.HALO, w3p)).astype(
                    np.float32)).to(dev)
            stages = ('full',)

            def run(r, s, stage):
                return fk.sap_full_padded(r, s, H, w3, 0.4)
        else:
            small = psb.pad_raster(raw.to(dtype), tile_h)
            big = psb.pad_raster(big_raw.to(dtype), tile_h)
            stages = fk.STAGES

            def run(r, s, stage):
                return fk.sap_stages(r, s, H, w3, stage)
        err = 0.0
        for stage in stages:
            got = run(small, seeds, stage)
            want = fk.sap_stages_plain(small, seeds, H, w3, stage)
            torch.cuda.synchronize()
            bad = (got != want).sum().item()
            err = max(err, (got.float() - want.float()).abs().max().item())
            log(f'kernel {name} {stage}: {bad} of {got.numel()} elements '
                f'differ (bit-exact required)')
            if bad:
                raise AssertionError(f'{name} {stage} differs from its plain '
                                     f'version')
            if stage == 'full' and name != 'sap_full_padded':
                eval_noise = fk.fused_sap_median_batched(raw.to(dtype), seeds,
                                                         0.4, True)
                if not torch.equal(got[:, :H, :w3].reshape(B, H, W, 3),
                                   eval_noise):
                    raise AssertionError(f'{name} full differs from the '
                                         f'eval noise kernel')
        per_stage = {}
        for stage in stages:
            # at the profiling path's own shape too, bit-exact
            out = run(big, big_seeds, stage)
            if not torch.equal(out, fk.sap_stages_plain(big, big_seeds, H,
                                                        w3, stage)):
                raise AssertionError(f'{name} {stage} differs from its plain '
                                     f'version at B={PROFILE_B}')
            log(f'kernel {name} {stage} at B={PROFILE_B}: equal to its plain '
                f'version')
            per_stage[stage] = dict(
                ms=time_ms(lambda: run(big, big_seeds, stage), 20),
                # read after the main paths: bind this stage's inputs now
                device_ms=later(lambda run=run, big=big, stage=stage: run(
                    big, big_seeds, stage), 20, SAP_STAGES),
                plain_ms=time_ms(lambda: fk.sap_stages_plain(
                    big, big_seeds, H, w3, stage), 2, 1),
                # the raster read once, the output written once
                **bound((big.numel() + out.numel()) * big.element_size(),
                        STAGE_OPS[stage] * out.numel()))
            del out
        if 'copy' in per_stage:
            per_stage['copy']['library_ms'] = time_ms(
                lambda: big[:, fk.HALO:fk.HALO + hp].clone(), 20)
        del big, small
        rows.append(dict(
            name=name, route='cuda',
            source='tpudenoise_torch/csrc/sap_stages.cu', replaces=line,
            max_abs_err=err, batch=PROFILE_B, tile_h=tile_h,
            stages=per_stage, **per_stage['full']))
    return rows


def _mix_errors(got, want):
    """Per-entry (max distance, changed share) of kernel against plain:
    mod-256 distance for the wrapped kinds, absolute for gaussian's
    floats (scaled by 1e6, so the bound reads 1 for both)."""
    out = []
    for i, (kind, _) in enumerate(MIX_ENTRIES):
        d = (got[i] - want[i]).abs()
        if kind in TRANSCENDENTAL:
            d = d * 1e6 if kind == 1 else torch.minimum(d, 256.0 - d)
        out.append((kind, d.max().item(), (d > 0).double().mean().item()))
    return out


def check_mix_kernels(dev) -> list:
    """Kernels 6-8 at full width against their plain versions."""
    rng = np.random.RandomState(5)
    n = len(MIX_ENTRIES)
    raw = rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    # the poisson image dark in its left half: lam < 10 there, so the
    # inverse CDF runs beside PTRS in one warp at the band's edge
    poisson = [k for k, _ in MIX_ENTRIES].index(int(Kind.POISSON))
    raw[poisson, :, :W // 2] //= 32
    raw = torch.from_numpy(raw).to(dev)
    keys = prng.split(prng.PRNGKey(5), n)
    kinds, *args = fixed_prologue(keys, raw, MIX_ENTRIES)
    rows = []
    for name, fn, plain, line in (
            ('fused_mix_noise', mk.fused_mix_noise, mk.fused_mix_noise_plain,
             'tpudenoise/noise/pallas_mix.py:521'),
            ('fused_mix_bilateral', mk.fused_mix_bilateral,
             mk.fused_mix_bilateral_plain,
             'tpudenoise/noise/pallas_mix.py:598')):
        got = fn(raw, *args, kinds)
        torch.cuda.synchronize()
        want = plain(raw, *args, kinds)
        errs = _mix_errors(got, want)
        log(f'kernel {name}: (kind, max dist, changed share) '
            + ' '.join(f'({k}, {m:g}, {s:.2e})' for k, m, s in errs)
            + ' (bound: 0 for kinds 0,3,5,7,8,11,12; dist 1 on 1e-3 for '
            'kinds 1,2,4,6,9,10)')
        for kind, m, share in errs:
            if (m > 0 if kind not in TRANSCENDENTAL
                    else m > 1 or share > 1e-3):
                raise AssertionError(f'{name}: kind {kind} outside its '
                                     f'bound ({m}, {share})')
        rows.append(dict(
            name=name, route='cuda',
            source='tpudenoise_torch/csrc/mix_noise.cu', replaces=line,
            max_abs_err=(got - want).abs().max().item(),
            ms=time_ms(lambda: fn(raw, *args, kinds), 10),
            device_ms=later(lambda fn=fn: fn(raw, *args, kinds), 10, (
                name.replace('fused_', '') + '_kernel', 'brownian_')),
            plain_ms=time_ms(lambda: plain(raw, *args, kinds), 2, 1),
            **bound(5 * raw.numel(), H * W * 3 * sum(
                MIX_OPS[k] + (OPS['bilateral'] if 'bilateral' in name
                              else 0) for k, _ in MIX_ENTRIES))))

    # kernel 7 at the main path's batch: 8 images drawn by the plan (its
    # bound from the kinds drawn), and 8 images of each kind alone, at the
    # kind's first level in MIX_ENTRIES
    row = rows[-1]
    praw, pkinds, pargs, drawn = pb.plan_inputs(dev)
    row['plan_kinds'] = drawn
    row['plan_ms'] = time_ms(
        lambda: mk.fused_mix_bilateral(praw, *pargs, pkinds), 10)
    row['plan_device_ms'] = later(
        lambda: mk.fused_mix_bilateral(praw, *pargs, pkinds), 10,
        ('mix_bilateral_kernel', 'brownian_'))
    row['plan_bound_ms'] = bound(5 * praw.numel(), H * W * 3 * sum(
        MIX_OPS[Kind[k.upper()]] + OPS['bilateral']
        for k in drawn))['bound_ms']
    row['per_kind_ms'] = {}
    for kind, level in MIX_ENTRIES[:13]:
        kraw, kk, kargs = pb.mix_inputs(dev, [(kind, level)] * B,
                                        seed=11 + kind)
        row['per_kind_ms'][Kind(kind).name.lower()] = time_ms(
            lambda: mk.fused_mix_bilateral(kraw, *kargs, kk), 10)
    log(f'kernel fused_mix_bilateral on {MIX_PLAN} chunk 0 '
        f'({", ".join(drawn)}): {row["plan_ms"]:.3f} ms, bound '
        f'{row["plan_bound_ms"]:.4f} ms; by kind (8 images each, ms): '
        + ', '.join(f'{k} {t:.3f}' for k, t in row['per_kind_ms'].items()))

    img = raw[:B]
    params = torch.from_numpy(bloom_params(prng.split(prng.PRNGKey(6), B),
                                           H, W)).to(dev)
    forms = {'u8': img, 'f32': img.to(torch.float32)}
    for form, x in forms.items():
        got = bl.bloom_batched(x, params)
        torch.cuda.synchronize()
        bad = (got.view(torch.int32) != bloom_apply_scan(x, params).view(
            torch.int32)).sum().item()
        log(f'kernel bloom on {form}: {bad} of {got.numel()} words differ '
            f'(bit-exact required)')
        if bad:
            raise AssertionError(f'bloom kernel differs from its plain '
                                 f'version on {form}')
    f32 = forms['f32']
    rows.append(dict(
        name='bloom_batched', route='cuda',
        source='tpudenoise_torch/csrc/bloom.cu',
        replaces='tpudenoise/noise/pallas_bloom.py:77', max_abs_err=0.0,
        ms=time_ms(lambda: bl.bloom_batched(img, params), 20),
        device_ms=later(lambda: bl.bloom_batched(img, params), 20,
                        ('bloom_kernel',)),
        f32_ms=time_ms(lambda: bl.bloom_batched(f32, params), 20),
        f32_device_ms=later(lambda: bl.bloom_batched(f32, params), 20,
                            ('bloom_kernel',)),
        plain_ms=time_ms(lambda: bloom_apply_scan(img, params), 3, 1),
        **bound(5 * img.numel(), OPS['bloom'] * img.numel())))
    return rows


def _dets(boxes, scores, mask, i, c):
    """(K, 5) kept detections of image i, class c."""
    m = mask[i, c]
    return np.hstack([boxes[i, c][m], scores[i, c][m][:, None]])


def check_small_chunk(dev):
    """The chunk on the card (f32) against the same chunk on the CPU:
    vgg16 for every small string, res50 for sap."""
    cases = []
    for backbone, noises in (('vgg16', SMALL_NOISES),
                             ('res50', ('sap_median_var0.4',))):
        model = FasterRCNN(backbone, num_classes=21, cfg=default_config(),
                           dtype=torch.float32)
        cases.append((backbone, model, seeded(model), noises))
    small_chunks(dev, cases)


def small_chunks(dev, cases):
    """Each case (tag, model, params, noises): two 120x200 images through
    detect_chunk on the CPU and on the card; >= 95% of the CPU's
    detections must have a card twin within 0.5 px (phase 4's
    tolerance)."""
    rng = np.random.RandomState(4)
    raw = torch.from_numpy(rng.randint(0, 256, (2, 120, 200, 3)).astype(
        np.uint8))
    geom = torch.tensor([[120, 200, 120, 200, 1.0]] * 2)
    bucket = (128, 224)
    res = {}
    for backbone, model, params, noises in cases:
        for d in ('cpu', dev):
            model.to(d)
            p = {k: v.to(d) for k, v in params.items()}
            for noise in noises:
                out = detect_chunk(model, p, prng.PRNGKey(3), [0, 1],
                                   raw.to(d), [(geom.to(d), bucket)],
                                   make_pipeline(noise))
                res[d, f'{backbone} {noise}'] = [t.cpu().numpy()
                                                 for t in out]
    for noise in sorted({n for _, n in res}):
        (cb, cs, cm), (gb, gs, gm) = res['cpu', noise], res[dev, noise]
        matched = total = 0
        for i in range(2):
            for c in range(cb.shape[1]):
                a = _dets(cb, cs, cm, i, c)
                g = _dets(gb, gs, gm, i, c)
                if abs(len(a) - len(g)) > 1:
                    raise AssertionError(f'{noise}: detection counts differ '
                                         f'({len(a)} vs {len(g)})')
                for row in a:
                    total += 1
                    matched += bool(g.size and
                                    np.abs(g - row).max(1).min() < 0.5)
        log(f'small chunk {noise}: {matched}/{total} CPU detections have a '
            f'card twin within 0.5 px')
        if total == 0 or matched / total < 0.95:
            raise AssertionError(f'{noise}: card and CPU chunks disagree')


COUNTERS = (fk.launches, nms.launches, mk.launches, bl.launches,
            bil.launches, prng.launches)
# the kernels each main path must launch, besides the two NMS kernels
# (twice a chunk each: the RPN's NMS and the postprocess NMS)
PATH_KERNELS = {'sap_median_var0.4': ('fused_sap_median_batched',),
                'gaussian_gaus_blur_var0.1': ('fused_gaussian_blur',),
                'noise_mix_var_all_bilateral': ('fused_mix_bilateral',),
                'noise_mix_var_all': ('fused_mix_noise',),
                'bloom': ('bloom_batched',),
                'speckle_bilateral_var1.0': ('threefry_draw',
                                             'bilateral_batched'),
                'poisson': ('threefry_draw',),
                'gaussian_wavelet_var0.1': ('threefry_draw',),
                'noise_mix_var_all_wavelet': ('fused_mix_noise',),
                'gamma_var0.3': ('threefry_draw',),
                'brownian_var0.09': ('threefry_draw',)}
NMS_KERNELS = (MASKS, WALK)
ENTRY_PATH = 'fused_sap_median entry'
PROFILE_PATH = 'profiling entry points'


def zero_counts():
    for counter in COUNTERS:
        for k in counter:
            counter[k] = 0


def launch_counts() -> dict:
    return {'fused_sap_median_batched': fk.launches['sap_median'],
            'fused_gaussian_blur': fk.launches['gauss_blur'],
            'fused_sap_median': fk.launches['sap_median_image'],
            MASKS: nms.launches['suppression_masks'],
            WALK: nms.launches['greedy_keep'],
            'fused_mix_noise': mk.launches['mix_noise'],
            'fused_mix_bilateral': mk.launches['mix_bilateral'],
            'bloom_batched': bl.launches['bloom'],
            'bilateral_batched': bil.launches['bilateral'],
            'threefry_draw': prng.launches['threefry'],
            'hash_draw': prng.launches['hash'],
            'sap_stages_f32': fk.launches['sap_stages_f32'],
            'sap_stages_u8': fk.launches['sap_stages_u8'],
            'sap_full_padded': fk.launches['sap_full_padded']}


def kinds_drawn(noise: str, key, idx) -> dict:
    """How many of the images idx draw each kind of a mixed plan."""
    plan = parse(noise)
    if len(plan.specs) < 2:
        return {}
    kinds, eb, el = plan_tables(plan.specs)
    keys = prng.split(prng.fold_in(key, np.asarray(idx)), 1)[:, 0]
    pos = entry_draws(keys, eb, el)[0]
    names = [Kind(kinds[p]).name.lower() for p in pos]
    return {n: names.count(n) for n in sorted(set(names))}


def chunk_inputs(dev, backbone: str):
    """A main path's model (seeded VOC-21 Faster R-CNN, bf16), its params,
    the (8, 600, 1000, 3) u8 frames, their one level (geometry, bucket)
    and the eval key."""
    cfg = default_config()
    model = FasterRCNN(backbone, num_classes=21, cfg=cfg)
    params = seeded(model)
    model.to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.RandomState(3)
    raw = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=dev)
    return model, params, raw, [(geom, BUCKET)], prng.PRNGKey(cfg.RNG_SEED)


def main_path(inputs, card: str, noises, tag: str = '',
              fast: bool = False) -> dict:
    """detect_chunk for each noise string: 3 warm and 5 timed chunks, the
    launch counters zeroed before and read after; results keyed
    `tag + noise` (+ ' --fast-rng' with fast: the pipeline's counter-hash
    draws, each string's hash launches exactly FAST_KERNELS' a chunk and
    no threefry draw)."""
    model, params, raw, levels, key = inputs
    stages = ('noise', 'prep', 'forward', 'postprocess')
    result = {}
    for noise in noises:
        noise_fn = make_pipeline(noise, fast_rng=fast)
        kernels = (tuple(FAST_KERNELS[noise]) if fast
                   else PATH_KERNELS[noise])
        walls, per_stage = [], {s: [] for s in stages}
        zero_counts()
        for it in range(8):
            # chunk `it` holds images 8*it .. 8*it+7, so each chunk draws
            # its own noise (and, for the mixes, its own kinds)
            idx = list(range(B * it, B * it + B))
            events = [torch.cuda.Event(enable_timing=True)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events[0].record()

            def mark(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            boxes, scores, mask = detect_chunk(model, params, key, idx, raw,
                                               levels, noise_fn,
                                               on_stage=mark)
            torch.cuda.synchronize()
            if it >= 3:
                walls.append(time.perf_counter() - t0)
                for s, a, b in zip(stages, events, events[1:]):
                    per_stage[s].append(a.elapsed_time(b))
        counts = launch_counts()
        missing = [k for k in kernels if not counts[k]]
        if missing:
            raise AssertionError(f'{noise}: the main path did not launch '
                                 f'{missing} ({counts})')
        if fast and (counts['threefry_draw'] or any(
                counts[k] != 8 * n for k, n in FAST_KERNELS[noise].items())):
            raise AssertionError(f'{noise} --fast-rng: launches {counts}, '
                                 f'expected {FAST_KERNELS[noise]} a chunk '
                                 f'and no threefry draw')
        if any(counts[k] != 2 * 8 for k in NMS_KERNELS):
            raise AssertionError(f'{noise}: not 2 launches a chunk of each '
                                 f'NMS kernel ({counts})')
        bx, sc, kept = (t.cpu().numpy() for t in (boxes, scores, mask))
        assert bx.shape == (B, 20, 100, 4), bx.shape
        if not (np.isfinite(bx).all() and np.isfinite(sc[kept]).all()):
            raise AssertionError(f'{noise}: non-finite detections')
        if not kept.any():
            raise AssertionError(f'{noise}: no detections kept')
        final = 0
        for j in range(B):
            # at most 100 kept, but for ties at the cut (the bf16 heads of
            # a seeded res101 tie often): as the reference, keep them all
            lim = sc[j][limit_per_image(bx[j], sc[j], kept[j], 100)]
            if len(lim) > 100 and (lim > lim.min()).sum() >= 100:
                raise AssertionError('limit_per_image did not cap at 100')
            final += len(lim)
        med = statistics.median(walls)
        name = tag + noise + (' --fast-rng' if fast else '')
        result[name] = dict(
            img_per_s=B / med, img_per_s_mean=B * len(walls) / sum(walls),
            img_per_s_range=(B / max(walls), B / min(walls)),
            chunk_ms=med * 1e3,
            stage_ms={s: statistics.median(v) for s, v in per_stage.items()},
            kept_per_image=float(kept.sum() / B),
            # after the cap of 100 per image; above 100 only for ties
            final_per_image=final / B,
            launches={k: counts[k] for k in kernels + NMS_KERNELS},
            kinds_timed=kinds_drawn(noise, key, range(3 * B, 8 * B)))
        r = result[name]
        log(f'main path {name}: {B / med:.1f} img/s (median of 5 chunks, '
            f'{med * 1e3:.2f} ms/chunk of {B}; mean '
            f'{r["img_per_s_mean"]:.1f}, min {B / max(walls):.1f}, max '
            f'{B / min(walls):.1f} img/s); stages ms: '
            + ', '.join(f'{s} {v:.2f}' for s, v in r['stage_ms'].items())
            + f'; {kept.sum() / B:.1f} kept/image, {final / B:.1f} after '
            f'the cap of 100; launches '
            f'{json.dumps(r["launches"])}'
            + (f'; kinds in the timed chunks {json.dumps(r["kinds_timed"])}'
               if r['kinds_timed'] else '') + f'  [{card}]')
    return result


def entry_path(raw, key) -> dict:
    """Kernel 4's own path: the per-image entry `fused_sap_median` on the
    first sap chunk's images and seeds (drawn as the sap pipeline draws
    them), counters zeroed before and read after; its output must equal
    the batched kernel's."""
    keys = prng.fold_in(key, np.arange(B))
    seeds = torch.from_numpy(prng.randint(keys, (1,), 0, 2**31 - 1)[:, 0]
                             ).to(raw.device)
    img = raw.to(torch.float32)
    zero_counts()
    out = fk.fused_sap_median(img, seeds, 0.4, True)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not counts['fused_sap_median']:
        raise AssertionError('the per-image entry did not launch its kernel')
    if not torch.equal(out, fk.fused_sap_median_batched(img, seeds, 0.4,
                                                        True)):
        raise AssertionError('the per-image entry differs from the batched '
                             'kernel')
    log(f'{ENTRY_PATH}: {counts["fused_sap_median"]} launches for {B} '
        f'images, equal to the batched kernel')
    return dict(launches={'fused_sap_median': counts['fused_sap_median']})


def profiling_path(dev, card: str) -> dict:
    """The profiling entry points at the scripts' size (B = 128), counters
    zeroed before and read after: `profile_sap_breakdown.run` (f32) and
    `u8_run` at their full stage, whose output must equal the plain eval
    noise, and `profile_fused.kernel_only_output`, whose whole (B, hp, w3p)
    output must equal the plain full stage on the same raster.  Then the
    images/s that the scripts print for the same three calls."""
    rng = np.random.RandomState(3)
    f32 = torch.from_numpy(rng.randint(0, 256, (PROFILE_B, H, W, 3)).astype(
        np.float32)).to(dev)
    u8 = f32.to(torch.uint8)
    seeds = torch.arange(PROFILE_B, dtype=torch.int32, device=dev)
    t_f32, t_u8 = PROFILE_TILES['sap_stages_f32'], PROFILE_TILES[
        'sap_stages_u8']
    zero_counts()
    outs = (psb.run(f32, seeds, t_f32, 'full'),
            psb.u8_run(u8, seeds, t_u8, 'full'),
            pf.kernel_only_output(PROFILE_TILES['sap_full_padded'], dev))
    torch.cuda.synchronize()
    counts = launch_counts()
    names = ('sap_stages_f32', 'sap_stages_u8', 'sap_full_padded')
    missing = [k for k in names if not counts[k]]
    if missing:
        raise AssertionError(f'the profiling path did not launch {missing}')
    for out, img in zip(outs, (f32, u8)):
        if not torch.equal(out, fk.fused_sap_median_plain(img, seeds, 0.4,
                                                          True)):
            raise AssertionError('a profiling stage differs from the plain '
                                 'eval noise')
    _, w3p, hp = psb.raster_geometry(H, W, PROFILE_TILES['sap_full_padded'])
    want = fk.sap_stages_plain(
        *pf.padded_raster(PROFILE_TILES['sap_full_padded'], dev), H, 3 * W,
        'full')
    if outs[2].shape != (PROFILE_B, hp, w3p) or not torch.equal(outs[2],
                                                                want):
        raise AssertionError('kernel_only output differs from its plain '
                             'version')
    del outs, want
    ips = {f'run full tile_h={t_f32}': psb.bench(
               lambda im, s: psb.run(im, s, t_f32, 'full'), f32, seeds),
           f'u8_run full tile_h={t_u8}': psb.bench(
               lambda im, s: psb.u8_run(im, s, t_u8, 'full'), u8, seeds),
           f'kernel_only tile_h={PROFILE_TILES["sap_full_padded"]}':
               pf.kernel_only(PROFILE_TILES['sap_full_padded'], dev)}
    log(f'{PROFILE_PATH}: launches {json.dumps({k: counts[k] for k in names})}'
        f'; img/s ' + ', '.join(f'{k} {v:.1f}' for k, v in ips.items())
        + f'  [{card}]')
    return dict(launches={k: counts[k] for k in names}, img_per_s=ips)


def _match_dets(want, got) -> tuple:
    """(matched, total) of detections `want` against `got`, lists of (K, 5)
    rows per image, at phase 4's tolerance: counts within one, and each
    wanted row with a twin within 0.5."""
    matched = total = 0
    for j, (a, g) in enumerate(zip(want, got)):
        if abs(len(a) - len(g)) > 1:
            raise AssertionError(f'image {j}: {len(g)} detections against '
                                 f'{len(a)}')
        for row in a:
            total += 1
            matched += bool(g.size and np.abs(g - row).max(1).min() < 0.5)
    return matched, total


def dataset_loop(card: str) -> dict:
    """The dataset loop on the card: a numpy-written rrData dataset of
    LOOP_IMAGES 600x1000 `.npy` images under build/ (filled rectangles as
    'person' boxes), `test_net_batched` with a seeded vgg16 (bf16) of
    rrData's two classes on sap_median_var0.4 through the port's rrData.
    The 10 APs must be finite and in [0, 1]; chunk 0's detections must
    match detect_chunk + limit_per_image on the same images and keys
    (phase 4's tolerance); the ground truth as detections must score
    1.0."""
    import os.path as osp
    import pickle
    import shutil

    root = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_data')
    shutil.rmtree(root, ignore_errors=True)
    pdir, gt = synthetic.write_rrdata(root, LOOP_IMAGES, (H, W), seed=12)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    imdb = rrData('test', config=cfg, pixel_dir=pdir)
    model = FasterRCNN('vgg16', num_classes=imdb.num_classes,
                       cfg=default_config())
    params = seeded(model)
    model.to(DEV)
    params = {k: v.to(DEV) for k, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aps = test_net_batched(model, params, imdb, 'vgg16_seeded', LOOP_NOISE,
                           eval_batch=B, config=cfg, bucket=BUCKET)
    wall = time.perf_counter() - t0
    if len(aps) != 10 or not all(np.isfinite(a) and 0 <= a <= 1
                                 for a in aps):
        raise AssertionError(f'dataset loop: APs {aps}')
    out_dir = get_output_dir(imdb.name, 'vgg16_seeded', cfg)
    with open(osp.join(out_dir, 'detections.pkl'), 'rb') as f:
        loop_dets = pickle.load(f)[1]

    # chunk 0 again through detect_chunk, as the loop builds it
    raw = torch.from_numpy(np.stack([read_bgr(imdb.image_path_at(i))
                                     for i in range(B)])).to(DEV)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=DEV)
    boxes, scores, mask = (t.cpu().numpy() for t in detect_chunk(
        model, params, prng.PRNGKey(cfg.RNG_SEED), list(range(B)), raw,
        [(geom, BUCKET)], make_pipeline(LOOP_NOISE, mode='TEST')))
    kept = np.stack([limit_per_image(boxes[j], scores[j], mask[j], 100)
                     for j in range(B)])
    matched, total = _match_dets([_dets(boxes, scores, kept, j, 0)
                                  for j in range(B)], loop_dets)
    if total == 0 or matched / total < 0.95:
        raise AssertionError(f'dataset loop chunk 0: {matched}/{total} '
                             f'detections match detect_chunk')
    gt_aps = imdb.evaluate_detections(synthetic.gt_detections(imdb, gt),
                                      osp.join(root, 'gt_eval'))
    if len(gt_aps) != 10 or not np.allclose(gt_aps, 1.0, rtol=1e-12,
                                            atol=0):
        raise AssertionError(f'ground truth scored {gt_aps}')
    log(f'dataset loop: {LOOP_IMAGES} images of {H}x{W} in {wall:.2f} s '
        f'({LOOP_IMAGES / wall:.1f} img/s, load and evaluation included); '
        f'AP@.5 {aps[0]:.4f}, AP@[.5,.95] {np.mean(aps):.4f}; chunk 0 '
        f'{matched}/{total} detections match detect_chunk; ground truth '
        f'scores {np.mean(gt_aps):.4f}  [{card}]')
    return dict(images=LOOP_IMAGES, wall_s=wall, img_per_s=LOOP_IMAGES / wall,
                aps=aps, chunk0_matched=[matched, total], root=root,
                pixel_dir=pdir)


def _timed(fn, *args):
    """(fn(*args), wall seconds), the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _demo_image(rng, h: int, w: int) -> np.ndarray:
    """A textured (h, w, 3) u8 frame with two filled rectangles."""
    img = (rng.rand(h, w, 3) * 60 + 60).astype(np.uint8)
    for _ in range(2):
        y, x = rng.randint(0, h - 120), rng.randint(0, w - 100)
        img[y:y + 110, x:x + 90] = rng.randint(180, 255, 3)
    return img


# the kernel wrappers the CLI paths launch, where those paths look them
# up, and each one's plain version: name -> (module, attribute, plain)
TAPPED = {'fused_sap_median_batched': (pipeline, 'fused_sap_median_batched',
                                       fk.fused_sap_median_plain),
          'fused_gaussian_blur': (pipeline, 'fused_gaussian_blur',
                                  fk.fused_gaussian_blur_plain),
          MASKS: (nms, 'build_suppression_masks_cuda',
                  nms.build_suppression_masks),
          WALK: (nms, 'greedy_keep', nms.greedy_keep_plain)}


@contextlib.contextmanager
def taped(tapped=None):
    """Record each call the enclosed block makes to a TAPPED (or `tapped`)
    wrapper: yields name -> [(args, kwargs, output)], the tensors cloned
    on the card (the inputs before the call)."""
    tapped = TAPPED if tapped is None else tapped
    calls, saved = {}, {}

    def tap(name, fn):
        def call(*a, **k):
            copy = [x.clone() if torch.is_tensor(x) else x for x in a]
            kw = {n: v.clone() if torch.is_tensor(v) else v
                  for n, v in k.items()}
            out = fn(*a, **k)
            calls.setdefault(name, []).append((copy, kw, out.clone()))
            return out
        return call

    for name, (mod, attr, _) in tapped.items():
        saved[name] = getattr(mod, attr)
        setattr(mod, attr, tap(name, saved[name]))
    try:
        yield calls
    finally:
        for name, (mod, attr, _) in tapped.items():
            setattr(mod, attr, saved[name])


def hold_to_plain(calls: dict, path: str, card: str) -> dict:
    """Each recorded launch of a CLI path against its wrapper's plain
    version on the same inputs: kernel 2 within its bound (max |diff| 1 on
    at most 1e-3 of the pixels), the others bit-exact.  Returns per kernel
    the launches held, their input shapes and the largest error."""
    held = {}
    for name, launches in calls.items():
        plain = TAPPED[name][2]
        err = share = 0.0
        for a, k, got in launches:
            want = plain(*a, **k)
            diff = (got.long() - want.long()).abs()
            e = diff.max().item()
            if name == 'fused_gaussian_blur':
                sh = (diff.amax(-1) > 0).double().mean().item()
                ok = e <= 1 and sh <= 1e-3
                share = max(share, sh)
            else:
                ok = e == 0
            if not ok:
                raise AssertionError(f'{path}: {name} at {tuple(a[0].shape)} '
                                     f'differs from its plain version '
                                     f'(max |diff| {e})')
            err = max(err, e)
        shapes = sorted({tuple(a[0].shape) for a, _, _ in launches})
        held[name] = dict(launches=len(launches), shapes=shapes,
                          max_abs_err=err, changed_share=share)
        log(f'{path}: {name} held to its plain version on its {len(launches)}'
            f' launches at {shapes}: max |diff| {err}'
            + (f', changed pixel share {share:.3e} (bound: max 1, share '
               f'1e-3)' if name == 'fused_gaussian_blur' else
               ' (bit-exact required)') + f'  [{card}]')
    return held


@contextlib.contextmanager
def patched(mod, attr, wrap):
    """mod.attr replaced by wrap(mod.attr) inside the block."""
    fn = getattr(mod, attr)
    setattr(mod, attr, wrap(fn))
    try:
        yield
    finally:
        setattr(mod, attr, fn)


def timing(fn, into: list):
    """fn, each call's wall time (the card synchronized at both ends)
    appended to into."""
    def call(*a, **k):
        out, t = _timed(lambda: fn(*a, **k))
        into.append(t)
        return out
    return call


def run_cli(main, argv):
    """main(argv) from the default module-level config, restored after;
    returns main's result, its wall time, the launch counts (zeroed just
    before) and a deep copy of the config it ran with."""
    import tpudenoise_torch.core.config as config
    defaults = copy.deepcopy(config.cfg)
    zero_counts()
    try:
        res, wall = _timed(main, argv)
        return res, wall, launch_counts(), copy.deepcopy(config.cfg)
    finally:
        config.cfg.clear()
        config.cfg.update(defaults)


def cli_inputs() -> dict:
    """The CLIs' inputs under build/chip_smoke_cli: a seeded res101 of
    rrData's two classes (full width and depth) written as .npz by
    save_params_npz, CLI_IMAGES numpy-written 600x1000 rrData images whose
    pixels lie in `get_imdb`'s pixel dir, and the demo's DEMO_SHAPES
    images as .npy."""
    import os.path as osp
    import shutil

    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.models.convert import save_params_npz

    repo = default_config().ROOT_DIR
    root = osp.join(repo, 'build', 'chip_smoke_cli')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    npz = osp.join(root, 'res101_seeded.npz')
    save_params_npz(seeded(FasterRCNN('res101', num_classes=2)), npz)
    data_cfg = default_config()
    data_cfg.ROOT_DIR = root
    synthetic.write_rrdata(root, CLI_IMAGES, (H, W), seed=13, pixel_dir=(
        default_pixel_dir('rrData_2021_test', data_cfg)))
    rng = np.random.RandomState(14)
    paths = []
    for i, (h, w) in enumerate(DEMO_SHAPES):
        paths.append(osp.join(root, f'demo{i}.npy'))
        np.save(paths[-1], _demo_image(rng, h, w))
    return dict(repo=repo, root=root, npz=npz, demo_paths=paths)


def demo_argv(inp: dict, sheet: str) -> list:
    return ['--net', 'res101', '--model', inp['npz'], '--noise', DEMO_NOISE,
            '--classes', '__background__', 'person', '--images',
            *inp['demo_paths'], '--out', sheet]


def check_demo_launches(counts: dict, path: str) -> dict:
    """kernel 2 once and kernel 3 and the walk twice an image."""
    n = len(DEMO_SHAPES)
    launches = {k: counts[k] for k in ('fused_gaussian_blur',) + NMS_KERNELS}
    if launches != {'fused_gaussian_blur': n, MASKS: 2 * n, WALK: 2 * n}:
        raise AssertionError(f'{path} launches {launches} for {n} images')
    return launches


def check_sheet(res: dict, sheet: str, path: str) -> tuple:
    from tpudenoise_torch.cli import demo as cli_demo
    shape = (max(h for h, _ in DEMO_SHAPES), sum(w for _, w in DEMO_SHAPES),
             3)
    if res['out'] != sheet or cli_demo.read_ppm(sheet).shape != shape:
        raise AssertionError(f'{path} sheet {res["out"]} is not {shape}')
    return shape


def cli_phase(card: str, inp: dict) -> dict:
    """The two CLIs in process, as a user calls them, each from the
    default module-level config, with no profiler.  cli.test: the seeded
    res101 .npz, its cfg file, --eval-batch 8 over the CLI_IMAGES images;
    10 finite APs, chunk 0 matching detect_chunk + limit_per_image (phase
    4's tolerance), kernel 1 once and kernel 3 and the walk twice a
    chunk.  cli.demo: the same weights on DEMO_NOISE over the four demo
    images (three landscape, one portrait: two buckets at scale 1.6); the
    sheet has the panels' shape, kernel 2 launched once and kernel 3 and
    the walk twice an image, and the portrait image's detections match
    detect_chunk with the demo's own model on the same key.  Every launch
    of both runs is held to its plain version on its own inputs
    (`hold_to_plain`).  Wall times: the whole main() (config, init,
    weights, eval), cli.test's test_net_batched, the demo's load_params
    and each image's noise + detection."""
    import os.path as osp
    import pickle

    from tpudenoise_torch.cli import demo as cli_demo
    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.eval import harness

    root, npz = inp['root'], inp['npz']
    out = {}

    # cli.test, its test_net_batched timed on the side
    loop = []
    with taped() as calls, patched(harness, 'test_net_batched',
                                   lambda fn: timing(fn, loop)):
        aps, wall, counts, cfg = run_cli(cli_test.main, [
            '--net', 'res101', '--cfg', osp.join(inp['repo'], 'experiments',
                                                 'cfgs', 'res101.yml'),
            '--imdb', 'rrData_2021_test', '--noise', LOOP_NOISE,
            '--eval-batch', str(B), '--model', npz,
            '--set', 'DATA_DIR', root, 'ROOT_DIR', root])
    chunks = CLI_IMAGES // B
    if len(aps) != 10 or not all(np.isfinite(a) and 0 <= a <= 1
                                 for a in aps):
        raise AssertionError(f'cli.test: APs {aps}')
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    if launches != {'fused_sap_median_batched': chunks, MASKS: 2 * chunks,
                    WALK: 2 * chunks}:
        raise AssertionError(f'cli.test launches {launches} for {chunks} '
                             f'chunks')
    held = hold_to_plain(calls, 'cli.test', card)
    del calls
    model = FasterRCNN('res101', num_classes=2, cfg=cfg)
    params, _ = cli_test.load_params(model, npz, 'res101',
                                     torch.Generator().manual_seed(
                                         cfg.RNG_SEED))
    model.to(DEV)
    params = {k: v.to(DEV) for k, v in params.items()}
    imdb = rrData('test', config=cfg, pixel_dir=default_pixel_dir(
        'rrData_2021_test', cfg))
    with open(osp.join(get_output_dir(imdb.name, npz.replace('/', '_'), cfg),
                       'detections.pkl'), 'rb') as f:
        cli_dets = pickle.load(f)[1][:B]
    raw = torch.from_numpy(np.stack([read_bgr(imdb.image_path_at(i))
                                     for i in range(B)])).to(DEV)
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=DEV)
    boxes, scores, mask = (t.cpu().numpy() for t in detect_chunk(
        model, params, prng.PRNGKey(cfg.RNG_SEED), list(range(B)), raw,
        [(geom, BUCKET)], make_pipeline(LOOP_NOISE, mode='TEST')))
    del model, params
    kept = np.stack([limit_per_image(boxes[j], scores[j], mask[j], 100)
                     for j in range(B)])
    matched, total = _match_dets([_dets(boxes, scores, kept, j, 0)
                                  for j in range(B)], cli_dets)
    if total == 0 or matched / total < 0.95:
        raise AssertionError(f'cli.test chunk 0: {matched}/{total} '
                             f'detections match detect_chunk')
    (eval_s,) = loop
    out['cli.test'] = dict(
        images=CLI_IMAGES, wall_s=wall, img_per_s=CLI_IMAGES / wall,
        eval_s=eval_s, eval_img_per_s=CLI_IMAGES / eval_s, aps=aps,
        chunk0_matched=[matched, total], launches=launches, held=held)
    log(f'cli.test res101 over {CLI_IMAGES} images of {H}x{W}, '
        f'{LOOP_NOISE}, --eval-batch {B}: main() {wall:.2f} s '
        f'({CLI_IMAGES / wall:.1f} img/s: config, init, weights and eval), '
        f'test_net_batched {eval_s:.2f} s ({CLI_IMAGES / eval_s:.1f} '
        f'img/s, load and evaluation included); AP@.5 {aps[0]:.4f}; chunk 0 '
        f'{matched}/{total} detections match detect_chunk; launches '
        f'{json.dumps(launches)}  [{card}]')

    # cli.demo: two buckets, no profiler; load_params and each image's
    # two steps timed, the demo's model kept for the portrait check
    sheet = osp.join(root, 'demo.ppm')
    load, noise_s, detect_s, model = [], [], [], []

    def keep_model(fn):
        def call(m, p, *a, **k):
            model[:] = [m, p]
            return fn(m, p, *a, **k)
        return timing(call, detect_s)

    with taped() as calls, \
            patched(cli_demo, 'load_params', lambda fn: timing(fn, load)), \
            patched(harness, 'noise_chunk', lambda fn: timing(fn, noise_s)), \
            patched(harness, 'detect_noisy', keep_model):
        res, wall, counts, dcfg = run_cli(cli_demo.main,
                                          demo_argv(inp, sheet))
    launches = check_demo_launches(counts, 'cli.demo')
    shape = check_sheet(res, sheet, 'cli.demo')
    demo_held = hold_to_plain(calls, 'cli.demo', card)
    del calls
    # the portrait image through detect_chunk: the same stages, batched
    j = len(inp['demo_paths']) - 1
    im = np.load(inp['demo_paths'][j])
    h0, w0 = im.shape[:2]
    s, oh, ow = rescale_geometry(h0, w0, cli_demo.TARGET_SIZE,
                                 cli_demo.MAX_SIZE)
    geom = torch.tensor([[h0, w0, oh, ow, s]], device=DEV)
    bucket = derive_bucket(cli_demo.TARGET_SIZE, cli_demo.MAX_SIZE,
                           portrait=h0 > w0)
    boxes, scores, mask = (t.cpu().numpy() for t in detect_chunk(
        *model, prng.PRNGKey(dcfg.RNG_SEED), [j],
        torch.from_numpy(im)[None].to(DEV), [(geom, bucket)],
        make_pipeline(DEMO_NOISE, mode='TEST')))
    del model[:]
    got = res['images'][j]
    matched, total = _match_dets(
        [_dets(boxes, scores, mask, 0, 0)],
        [_dets(got['boxes'][None], got['scores'][None], got['mask'][None], 0,
               0)])
    if total == 0 or matched / total < 0.95:
        raise AssertionError(f'cli.demo image {j}: {matched}/{total} '
                             f'detections match detect_chunk')
    n = len(DEMO_SHAPES)
    per_image = [a + b for a, b in zip(noise_s, detect_s)]
    (load_s,) = load
    out['cli.demo'] = dict(images=n, wall_s=wall, img_per_s=n / wall,
                           load_params_s=load_s, image_s=per_image,
                           sheet=list(shape),
                           portrait_matched=[matched, total],
                           launches=launches, held=demo_held)
    shapes = ', '.join(f'{h}x{w}' for h, w in DEMO_SHAPES)
    buckets = sorted({derive_bucket(cli_demo.TARGET_SIZE, cli_demo.MAX_SIZE,
                                    h > w) for h, w in DEMO_SHAPES})
    log(f'cli.demo res101 over {n} images ({shapes}; scale {s:g}, buckets '
        f'{buckets}), {DEMO_NOISE}: main() {wall:.2f} s ({n / wall:.2f} '
        f'img/s: config, init, weights, images and sheet included), of '
        f'which load_params {load_s:.2f} s and each image\'s noise + '
        f'detection ' + ', '.join(f'{t:.3f}' for t in per_image)
        + f' s (the rest {wall - load_s - sum(per_image):.2f} s); sheet '
        f'{shape}; portrait image {matched}/{total} detections match '
        f'detect_chunk; launches {json.dumps(launches)}  [{card}]')
    return out


def cli_profiled(card: str, inp: dict) -> dict:
    """cli.demo again, under --profile: after the profiled chunks, since a
    profiler session slows what runs after it.  The sheet and a trace
    file must exist, the launches as without the profiler.  Times the
    whole main(), the profiler's start (entering `trace`), the block it
    profiles and its stop + Chrome-trace export apart."""
    import glob
    import os.path as osp

    from tpudenoise_torch.cli import demo as cli_demo
    from tpudenoise_torch.utils import profiling

    trace_dir = osp.join(inp['root'], 'demo_trace')
    sheet = osp.join(inp['root'], 'demo_profiled.ppm')
    marks = []

    def timed_trace(trace):
        @contextlib.contextmanager
        def call(logdir):
            marks.append(time.perf_counter())
            with trace(logdir):
                marks.append(time.perf_counter())
                yield
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            marks.append(time.perf_counter())
        return call

    with patched(profiling, 'trace', timed_trace):
        res, wall, counts, _ = run_cli(
            cli_demo.main, demo_argv(inp, sheet) + ['--profile', trace_dir])
    path = 'cli.demo --profile'
    launches = check_demo_launches(counts, path)
    shape = check_sheet(res, sheet, path)
    traces = glob.glob(osp.join(trace_dir, '*.json'))
    if not traces or not os.path.getsize(traces[0]):
        raise AssertionError(f'{path} wrote no trace in {trace_dir}')
    start, block, export = np.diff(marks)
    n = len(DEMO_SHAPES)
    log(f'{path} res101 over {n} images, {DEMO_NOISE}: main() {wall:.2f} s '
        f'({n / wall:.2f} img/s), of which the profiler\'s start '
        f'{start:.2f} s, the profiled images {block:.2f} s, its stop and '
        f'Chrome-trace export {export:.2f} s ({os.path.getsize(traces[0])} '
        f'bytes); sheet {shape}, trace {osp.basename(traces[0])}; launches '
        f'{json.dumps(launches)}  [{card}]')
    return {path: dict(images=n, wall_s=wall, img_per_s=n / wall,
                       profiler_start_s=start, profiled_s=block,
                       profiler_export_s=export,
                       trace_bytes=os.path.getsize(traces[0]),
                       sheet=list(shape), launches=launches)}


# ----------------------------------------------------------- training --

TRAIN_IMAGES = 16
TRAIN_NOISE = 'sap_median_var0.4'
VGG_TRAIN_NOISE = 'gaussian_gaus_blur_var0.1'
# one step each through the masked generic route (bloom, kernel 8; the
# gaussian wavelet: its threefry field, then the wavelet twice with
# statistics over each image's valid region) and the masked bilateral
# route (speckle's threefry field, kernel 5 twice)
MASKED_NOISES = ('bloom', 'speckle_bilateral_var1.0',
                 'gaussian_wavelet_var0.1')
TRAIN_TIMED = 5
# threefry draws a step: the anchor targets' two uniform fields, the
# proposal targets' two uniform fields and two randints of two bit fields
# each, and each vgg16 dropout's field
TRAIN_DRAWS = {'res101': 8, 'vgg16': 10, 'mobile': 8}
# the kernels a training step launches for its noise string, a step
TRAIN_NOISE_LAUNCHES = {
    TRAIN_NOISE: {'fused_sap_median_batched': 1},
    VGG_TRAIN_NOISE: {'fused_gaussian_blur': 1},
    'bloom': {'bloom_batched': 1},
    'speckle_bilateral_var1.0': {'bilateral_batched': 2, 'threefry_draw': 1},
    'gaussian_wavelet_var0.1': {'threefry_draw': 1}}
# kernel wrappers the training path launches, beside the CLI phase's
TRAIN_TAPPED = {**TAPPED,
                'threefry_draw': (prng, 'threefry_draw',
                                  prng.threefry_draw_plain),
                'bloom_batched': (pipeline, 'bloom_batched',
                                  bloom_apply_scan),
                'bilateral_batched': (pipeline, 'bilateral_batched',
                                      bil.bilateral_plain),
                'hash_draw': (prng, 'hash_draw', prng.hash_draw_plain)}
# step 1's losses on the card (f32) against the CPU's plain versions: the
# RPN terms do not depend on the sampled proposals; the RoI terms do, and
# a proposal whose score ties another within rounding could swap places
# (none has: the RoI terms agreed to 3.9e-5 with TRAIN.USE_GT off)
TRAIN_RPN_RTOL = 1e-3
TRAIN_ROI_RTOL = 1e-3


def hold_train_to_plain(calls: dict, path: str, card: str) -> dict:
    """Each recorded launch of a training path against its wrapper's plain
    version on the same inputs: kernel 2 within its bound (max |diff| 1 on
    at most 1e-3 of the pixels); the threefry draw's normals within 2 ulp;
    everything else bit-exact."""
    held = {}
    for name, launches in calls.items():
        plain = TRAIN_TAPPED[name][2]
        err = 0.0
        for a, k, got in launches:
            want = plain(*a, **k)
            if name in ('threefry_draw', 'hash_draw'):
                e = (got.view(torch.int32).long()
                     - want.to(got.dtype).view(torch.int32).long()).abs()
                e = e.max().item()
                mode = a[2] if name == 'threefry_draw' else a[3]
                ok = e <= (2 if mode == 'normal' else 0)
            elif name == 'fused_gaussian_blur':
                diff = (got.double() - want.double()).abs()
                e = diff.max().item()
                ok = e <= 1 and (diff.amax(-1) > 0).double().mean() <= 1e-3
            else:
                e = (got.double() - want.double()).abs().max().item()
                ok = e == 0
            if not ok:
                raise AssertionError(f'{path}: {name} at {tuple(a[0].shape)} '
                                     f'differs from its plain version '
                                     f'({e})')
            err = max(err, e)
        shapes = sorted({tuple(a[0].shape) for a, _, _ in launches})
        held[name] = dict(launches=len(launches), shapes=shapes[:4],
                          max_abs_err=err)
        log(f'{path}: {name} held to its plain version on its {len(launches)}'
            f' launches at {shapes[:4]}: max error {err}'
            + (' (ulps)' if name in ('threefry_draw', 'hash_draw') else '')
            + f'  [{card}]')
    return held


def train_inputs() -> dict:
    """16 numpy-written 600x1000 rrData trainval images under
    build/chip_smoke_train, their `.npy` pixels where `get_imdb` looks."""
    import os.path as osp
    import shutil

    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    repo = default_config().ROOT_DIR
    root = osp.join(repo, 'build', 'chip_smoke_train')
    shutil.rmtree(root, ignore_errors=True)
    cfg = default_config()
    cfg.ROOT_DIR = root
    synthetic.write_rrdata(root, TRAIN_IMAGES, (H, W), seed=21,
                           image_set='trainval',
                           pixel_dir=default_pixel_dir('rrData_2021_trainval',
                                                       cfg))
    return dict(repo=repo, root=root)


def train_argv(inp: dict, net: str, noise: str, iters: int, tag: str
               ) -> list:
    import os.path as osp
    return ['--net', net, '--cfg', osp.join(inp['repo'], 'experiments',
                                            'cfgs', f'{net}.yml'),
            '--imdb', 'rrData_2021_trainval', '--imdbval',
            'rrData_2021_trainval', '--iters', str(iters), '--noise', noise,
            '--tag', tag, '--set', 'DATA_DIR', inp['root'], 'ROOT_DIR',
            inp['root'], 'TRAIN.DISPLAY', '1', 'TRAIN.SNAPSHOT_ITERS', '3']


@contextlib.contextmanager
def recording():
    """Each training iteration's keys and batch (`train_model`'s on_step),
    and the states `Solver.restore` returns, while the block runs."""
    from tpudenoise_torch.train import solver as solver_mod
    seen, restored = [], []

    def on_step(it, key, k_noise, k_step, raw, losses):
        # the losses read back first: t is when the step had finished
        losses = {k: v.item() for k, v in losses.items()}
        seen.append(dict(it=it, t=time.perf_counter(), key=key.tolist(),
                         k_noise=k_noise.tolist(),
                         k_step=k_step.tolist(),
                         batch={k: v.copy() for k, v in raw.items()},
                         losses=losses))

    def train_model(fn):
        def call(self, max_iters, resume=True, on_step=None):
            return fn(self, max_iters, resume, on_step=record)
        return call

    record = on_step

    def restore(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            restored.append(out)
            return out
        return call

    with patched(solver_mod.Solver, 'train_model', train_model), \
            patched(solver_mod.Solver, 'restore', restore):
        yield seen, restored


def check_train_launches(counts: dict, net: str, noise: str, iters: int,
                         path: str, fast: bool = False) -> dict:
    """The step's noise kernels, kernel 3 and the walk once a step (one
    image a batch) and the threefry draws of the targets (and dropout);
    with fast, the noise's hash draws (FAST_KERNELS) in place of its
    threefry draws."""
    want = {MASKS: iters, WALK: iters,
            'threefry_draw': TRAIN_DRAWS[net] * iters}
    noise_launches = (FAST_KERNELS[noise] if fast
                      else TRAIN_NOISE_LAUNCHES[noise])
    for k, n in noise_launches.items():
        want[k] = want.get(k, 0) + n * iters
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f'{path} launches {got}, expected {want}')
    return got


def train_cli(card: str, inp: dict, net: str, noise: str, iters: int,
              tag: str, fast: bool = False, extra=(), check: bool = True
              ) -> tuple:
    """cli.trainval in process (with --fast-rng when fast, and the flags
    of extra), every launch taped and held to its plain version; with
    check, the launches as one image a step makes them, else each
    counted kernel launched at least once; returns (entry for e2e, the
    final state, the iterations seen, the states restored, the config it
    ran with)."""
    from tpudenoise_torch.cli import trainval
    path = (f'train {net} {noise} --iters {iters}'
            + (' --fast-rng' if fast else '') + ''.join(
                f' {a}' for a in extra))
    with taped(TRAIN_TAPPED) as calls, recording() as (seen, restored):
        state, wall, counts, cfg = run_cli(
            trainval.main, (['--fast-rng'] if fast else []) + list(extra)
            + train_argv(inp, net, noise, iters, tag))
    if check:
        launches = check_train_launches(counts, net, noise, len(seen), path,
                                        fast)
    else:
        launches = {k: counts[k] for k in calls}
        if not all(launches.values()):
            raise AssertionError(f'{path} launches {launches}')
    held = hold_train_to_plain(calls, path, card)
    losses = [s['losses'] for s in seen]
    if not all(np.isfinite(v) for x in losses for v in x.values()):
        raise AssertionError(f'{path}: non-finite losses {losses}')
    log(f'{path}: iterations {[s["it"] for s in seen]} in {wall:.2f} s '
        f'(main(): config, init, data, steps, snapshots); total_loss '
        + ', '.join(f'{x["total_loss"]:.4f}' for x in losses)
        + f'; launches {json.dumps(launches)}  [{card}]')
    entry = dict(wall_s=wall, iterations=[s['it'] for s in seen],
                 losses=losses, launches=launches, held=held)
    return entry, state, seen, restored, cfg, calls


def expected_sequence(cfg, iters: int) -> list:
    """The keys and batches of an uninterrupted run: the solver's key
    algebra and loader over the same roidb, with no model."""
    from tpudenoise_torch.data.loader import RoiDataLoader
    from tpudenoise_torch.data.roidb import combined_roidb, filter_roidb
    from tpudenoise_torch.utils.blob import derive_bucket
    imdb, roidb = combined_roidb('rrData_2021_trainval', TRAIN_NOISE, cfg)
    roidb = filter_roidb(roidb, cfg)
    loader = RoiDataLoader(roidb, imdb.num_classes, cfg, bucket=derive_bucket(
        cfg.TRAIN.SCALES[0], cfg.TRAIN.MAX_SIZE))
    key, out = prng.PRNGKey(cfg.RNG_SEED), []
    for it in range(1, iters + 1):
        key, kn, ks = prng.split(key, 3)
        out.append(dict(it=it, key=key.tolist(), k_noise=kn.tolist(),
                        k_step=ks.tolist(), batch=loader.forward()))
    return out


def check_resume(first, second, restored, cfg, path: str) -> dict:
    """The restored state equals the first run's final one bit for bit
    (params, momentum, step, key), and the iterations of the two runs
    together see the keys and batches of an uninterrupted run."""
    state6, seen6 = first
    (got, key, it), = restored
    same = (it == len(seen6) and got.step == state6.step
            and key.tolist() == seen6[-1]['key']
            and all(torch.equal(got.params[k], state6.params[k])
                    for k in state6.params)
            and all(torch.equal(got.momentum[k], state6.momentum[k])
                    for k in state6.momentum))
    if not same:
        raise AssertionError(f'{path}: the restored state differs from the '
                             f'saved one')
    seen = seen6 + second
    want = expected_sequence(cfg, len(seen))
    for s, w in zip(seen, want):
        if (s['it'], s['key'], s['k_noise'], s['k_step']) != (
                w['it'], w['key'], w['k_noise'], w['k_step']) or not all(
                np.array_equal(s['batch'][k], w['batch'][k])
                for k in w['batch']):
            raise AssertionError(f'{path}: iteration {s["it"]} sees another '
                                 f'key or batch than an uninterrupted run')
    log(f'{path}: the restored state equals the saved one bit for bit '
        f'(params, momentum, step {got.step}, key); iterations '
        f'{[s["it"] for s in seen]} see the keys and batches of an '
        f'uninterrupted run')
    return dict(restored_equal=True, sequence_equal=len(seen))


def train_setup(cfg, dtype, dev, name: str, init=None, net='res101'):
    """A solver of net (res101 by default) on the training phase's data
    on dev, its loader and its state (the seeded init, or `init` moved
    to dev)."""
    from tpudenoise_torch.data.loader import RoiDataLoader
    from tpudenoise_torch.data.roidb import combined_roidb, filter_roidb
    from tpudenoise_torch.train.solver import Solver
    imdb, roidb = combined_roidb('rrData_2021_trainval', TRAIN_NOISE, cfg)
    roidb = filter_roidb(roidb, cfg)
    out = os.path.join(default_config().ROOT_DIR, 'build',
                       'chip_smoke_train', name)
    s = Solver(FasterRCNN(net, num_classes=2, cfg=cfg, dtype=dtype),
               imdb, roidb, [], out, out + '_tb', noise=TRAIN_NOISE,
               config=cfg, device=dev)
    init = init or s._init_state_fn(torch.Generator().manual_seed(
        cfg.RNG_SEED), s.bucket)
    state = init._replace(
        params={k: v.to(dev) for k, v in init.params.items()},
        momentum={k: v.to(dev) for k, v in init.momentum.items()})
    return s, RoiDataLoader(roidb, 2, cfg, bucket=s.bucket), state, init


def train_step1(card: str, cfg) -> dict:
    """Step 1 of the res101 run's data and keys with an f32 res101 (the
    seeded init) on the card and through the plain versions on the CPU:
    each loss term within its stated tolerance.  TRAIN.USE_GT puts the gt
    boxes among the proposals, so that foreground RoIs are sampled and the
    class-expanded bbox targets and weights and the RoI smooth-L1 are held
    too (the seeded RPN's proposals, near its 88-512 px anchors, overlap
    none of the 40-90 x 60-110 px gt boxes by 0.5): loss_box must be
    non-zero on both sides."""
    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.USE_GT = True
    out = {}
    init = None
    for dev in ('cuda', 'cpu'):
        s, loader, state, init = train_setup(cfg, torch.float32, dev,
                                             'step1', init)
        _, kn, ks = prng.split(prng.PRNGKey(cfg.RNG_SEED), 3)
        t0 = time.perf_counter()
        batch = s._prep_batch(kn, loader.forward())
        _, losses = s._step_fn(state, ks, batch, update=dev == 'cuda')
        out[dev] = {k: v.item() for k, v in losses.items()}
        out[dev + '_s'] = time.perf_counter() - t0
    errs = {k: abs(out['cuda'][k] - out['cpu'][k]) / max(abs(out['cpu'][k]),
                                                         1e-12)
            for k in out['cpu']}
    for k, e in errs.items():
        tol = TRAIN_RPN_RTOL if k.startswith('rpn') else TRAIN_ROI_RTOL
        if not e <= tol or not np.isfinite(out['cuda'][k]):
            raise AssertionError(f'train step 1 (f32): {k} card '
                                 f'{out["cuda"][k]} vs CPU {out["cpu"][k]}')
    if not (out['cuda']['loss_box'] > 0 and out['cpu']['loss_box'] > 0):
        raise AssertionError(f'train step 1 (f32, TRAIN.USE_GT): no '
                             f'foreground RoI, loss_box card '
                             f'{out["cuda"]["loss_box"]} CPU '
                             f'{out["cpu"]["loss_box"]}')
    log('train step 1, res101 f32, TRAIN.USE_GT, card vs CPU plain versions: '
        + ', '.join(f'{k} {out["cuda"][k]:.9g}/{out["cpu"][k]:.9g} '
                    f'(rel {errs[k]:.2e})' for k in errs)
        + f'; bounds: rpn terms {TRAIN_RPN_RTOL}, RoI terms and total '
        f'{TRAIN_ROI_RTOL}; CPU step {out["cpu_s"]:.1f} s  [{card}]')
    return dict(card=out['cuda'], cpu=out['cpu'], rel_err=errs)


def train_timing(card: str, cfg) -> dict:
    """The res101 bf16 step at 608x1024, batch 1: 2 warm steps, then
    TRAIN_TIMED timed ones, each split by CUDA events into noise (the
    batch's transfer, noise and mean subtraction), forward + losses,
    backward and optimizer; the peak memory of the timed steps; then one
    step under set_sync_debug_mode('warn'), listing where the step waits
    on the device."""
    import collections
    import traceback
    import warnings

    s, loader, state, _ = train_setup(cfg, torch.bfloat16, DEV, 'timed')
    key = prng.PRNGKey(cfg.RNG_SEED)
    stages = ('noise', 'forward', 'backward', 'optimizer')
    rec = []

    def step(state, key, events=None):
        key, kn, ks = prng.split(key, 3)
        raw = loader.forward()
        if events is not None:
            events[0].record()
        batch = s._prep_batch(kn, raw)
        if events is not None:
            events[1].record()
        marks = iter(events[2:]) if events is not None else None
        state, losses = s._step_fn(
            state, ks, batch,
            mark=(lambda stage: next(marks).record()) if marks else None)
        return state, key, losses

    for _ in range(2):
        state, key, _ = step(state, key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state, key, losses = step(state, key, ev)
        rec.append(ev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated()
    split = {st: statistics.median(e[i].elapsed_time(e[i + 1]) for e in rec)
             for i, st in enumerate(stages)}
    step_ms = statistics.median(e[0].elapsed_time(e[4]) for e in rec)
    repo = default_config().ROOT_DIR
    syncs = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        # where the port called the op that waited: its innermost frames
        # in the repo, the caller's caller last
        # torch's own note that the mode is a prototype is not a sync
        if 'called a synchronizing' in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if f.filename.startswith(repo)]
            syncs[' <- '.join(f'{os.path.relpath(f.filename, repo)}:'
                              f'{f.lineno}' for f in frames[::-1][:3])
                  or f'{filename}:{lineno}'] += 1

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        try:
            state, key, losses = step(state, key)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    log(f'train step res101 bf16 608x1024 batch 1 ({TRAIN_NOISE}): median '
        f'{step_ms:.2f} ms ({1e3 / step_ms:.2f} img/s; host wall '
        f'{wall:.2f} ms a step), stages (median ms) '
        + ', '.join(f'{k} {v:.2f}' for k, v in split.items())
        + f'; peak memory {peak / 2**30:.2f} GiB; one step under '
        f'set_sync_debug_mode warn: {sum(syncs.values())} synchronizing '
        f'calls at {dict(syncs)}  [{card}]')
    return dict(step_ms=step_ms, img_per_s=1e3 / step_ms, host_ms=wall,
                stages_ms=split, peak_bytes=peak, syncs=dict(syncs),
                solver=s, state=state, key=key, loader=loader, step=step)


def nms_rows(calls: dict, rows: list, card: str, key: str, what: str,
             pick=lambda launches: launches[0]):
    """Kernel 3 and the walk at a path's own size: the picked recorded
    launch's inputs (default the first), each timed beside its plain
    version, with its bound; attached to their kernel rows under key."""
    a, k, words = pick(calls[MASKS])
    sboxes, thresh = a[0], a[1]
    wa, wk, keep = pick(calls[WALK])
    by_name = {r['name']: r for r in rows}
    by_name[MASKS][key] = dict(
        what=what, shape=list(sboxes.shape),
        ms=time_ms(lambda: nms.build_suppression_masks_cuda(sboxes, thresh),
                   20),
        device_ms=later(lambda: nms.build_suppression_masks_cuda(
            sboxes, thresh), 20, ('mask_kernel',)),
        plain_ms=time_ms(lambda: nms.build_suppression_masks(sboxes, thresh),
                         2, 1),
        **mask_bound(sboxes, words))
    by_name[WALK][key] = dict(
        what=what, shape=list(wa[0].shape), max_outputs=wa[2],
        kept=(keep >= 0).sum().item(),
        ms=time_ms(lambda: nms.greedy_keep(*wa), 20),
        device_ms=later(lambda: nms.greedy_keep(*wa), 20,
                        ('greedy_kernel',)),
        plain_ms=time_ms(lambda: nms.greedy_keep_plain(*wa), 2, 1),
        **walk_bound(wa[0], nms.greedy_keep_plain(*wa), wa[2]))
    for name in (MASKS, WALK):
        r = by_name[name][key]
        log(f'{name} at {what} {r["shape"]}: kernel {r["ms"]:.3f} ms, '
            f'plain {r["plain_ms"]:.2f} ms, bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]})  [{card}]')


def train_phase(card: str, rows: list) -> dict:
    """Training on the card through cli.trainval, as a user calls it:
    res101 (seeded, full width and depth, rrData's two classes) on the 16
    600x1000 images, bucket (608, 1024), batch 1, sap_median_var0.4, 6
    iterations with a snapshot every 3, then a second call with --iters 8
    that resumes from 6; vgg16 3 iterations on gaussian_gaus_blur_var0.1
    (dropout); one res101 step each on bloom and speckle_bilateral_var1.0
    (the masked generic and bilateral routes).  Every call's losses
    finite, its launches as expected and each launch held to its plain
    version; the restored state equal to the saved one and the resumed
    keys and batches those of an uninterrupted run; step 1 on the card
    (f32) against the CPU; then the timed steps.  Returns the paths (each
    with its launches), the other results, and the timed solver's state
    for `train_profiled`."""
    inp = train_inputs()
    out, info = {}, {}
    t0 = time.perf_counter()
    e, state6, seen6, _, cfg, calls = train_cli(card, inp, 'res101',
                                                TRAIN_NOISE, 6, 'res101')
    out['train res101 6'] = e
    nms_rows(calls, rows, card, 'train_rpn', 'the training RPN size')
    del calls
    e, _, seen8, restored, _, calls = train_cli(card, inp, 'res101',
                                                TRAIN_NOISE, 8, 'res101')
    del calls
    e.update(check_resume((state6, seen6), seen8, restored, cfg,
                          'train res101 resume'))
    out['train res101 resume to 8'] = e
    del state6, restored
    e, *_ = train_cli(card, inp, 'vgg16', VGG_TRAIN_NOISE, 3, 'vgg16')
    out['train vgg16 3'] = e
    for noise in MASKED_NOISES:
        e, *_ = train_cli(card, inp, 'res101', noise, 1, noise)
        out[f'train res101 {noise}'] = e
    info['step 1 card vs CPU'] = train_step1(card, cfg)
    timing_ = train_timing(card, cfg)
    info['timing'] = {k: v for k, v in timing_.items()
                      if k not in ('solver', 'state', 'key', 'loader',
                                   'step')}
    info['wall_s'] = time.perf_counter() - t0
    log(f'training phase: {info["wall_s"]:.1f} s of wall time  [{card}]')
    return out, info, timing_


def train_profiled(card: str, timing_: dict) -> dict:
    """Two more timed steps under torch.profiler: the device's idle share
    of the step and its busiest kernels (last: a profiler session slows
    what runs after it)."""
    from torch.profiler import ProfilerActivity, profile
    state, key, step = timing_['state'], timing_['key'], timing_['step']
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, key, _ = step(state, key)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type.name == 'CUDA' and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in kern) / 2e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    log(f'profile train step res101: step {wall:.2f} ms, device {busy:.2f} '
        f'ms, idle {1 - busy / wall:.1%}; top (name, ms/step, calls): '
        + '; '.join(f'{e.key[:60]} {e.self_device_time_total / 2e3:.3f} '
                    f'x{e.count // 2}' for e in top) + f'  [{card}]')
    return dict(wall_ms=wall, device_ms=busy, idle_share=1 - busy / wall,
                top=[(e.key[:90], e.self_device_time_total / 2e3,
                      e.count // 2) for e in top])


def check_wavelet(dev, card: str) -> dict:
    """The wavelet denoiser (torch f32 matmuls, no kernel of the port's
    own) on (8, 600, 1000, 3) unit floats, without and with per-image
    valid extents, on the card against the same function on the CPU:
    floats within WAVELET_TOL, and wrap_cast_u8(255 * w) within a mod-256
    distance of 1 on at most WAVELET_U8_SHARE of the elements.  Timed by
    CUDA events; its bound is the banded matmuls' operations over 67
    T/s."""
    from tpudenoise_torch.denoise import wavelet as wv
    from tpudenoise_torch.noise.generators import wrap_cast_u8
    rng = np.random.RandomState(8)
    base = rng.rand(B, 1, 1, 3) * 0.6 + 0.2
    x = np.clip(base + rng.randn(B, H, W, 3) * 0.15, 0, 1).astype(
        np.float32)
    img = torch.from_numpy(x)
    hw = np.array([(H - 13 * i, W - 29 * i) for i in range(B)], np.int64)
    out = {}
    for form, ext in (('full', None), ('hw', hw)):
        t0 = time.perf_counter()
        want = wv.denoise_wavelet_batched(img, hw=ext)
        cpu_s = time.perf_counter() - t0
        got = wv.denoise_wavelet_batched(img.to(dev), hw=ext).cpu()
        err = (got - want).abs().max().item()
        d = (wrap_cast_u8(255.0 * got) - wrap_cast_u8(255.0 * want)).abs()
        d = torch.minimum(d, 256.0 - d)
        share = (d > 0).double().mean().item()
        xd = img.to(dev)
        ms = time_ms(lambda: wv.denoise_wavelet_batched(xd, hw=ext), 5)
        flops = wv.matmul_flops(3 * B, H, W)
        out[form] = dict(max_abs_err=err, u8_max_dist=d.max().item(),
                         u8_changed_share=share, ms=ms, cpu_ms=cpu_s * 1e3,
                         matmul_flops=flops,
                         bound_ms=flops / OPS_PER_S * 1e3,
                         bound_by='operations')
        log(f'wavelet denoise_wavelet_batched ({B}, {H}, {W}, 3) {form}: '
            f'card vs CPU max |diff| {err:.3g} (bound {WAVELET_TOL}); u8 '
            f'cast mod-256 max {d.max().item():g} on {share:.2e} of the '
            f'elements (bound 1 on {WAVELET_U8_SHARE}); {ms:.3f} ms by CUDA '
            f'events, CPU {cpu_s * 1e3:.0f} ms; {flops / 1e9:.1f} GFLOP of '
            f'banded matmuls, bound {flops / OPS_PER_S * 1e3:.3f} ms '
            f'(operations)  [{card}]')
        if not (err <= WAVELET_TOL and d.max().item() <= 1
                and share <= WAVELET_U8_SHARE):
            raise AssertionError(f'wavelet {form}: card and CPU disagree')
    return out


# the grid phase: the fixture's split sizes, iterations and snapshot
GRID_ITERS, GRID_SNAPSHOT, GRID_TRAIN, GRID_TEST = 20, 10, 16, 8
# kinds whose generic route draws through the threefry kernel
THREEFRY_KINDS = {Kind.GAUSSIAN, Kind.POISSON, Kind.SAP, Kind.SPECKLE,
                  Kind.UNIFORM, Kind.GAMMA, Kind.RAYLEIGH, Kind.BROWNIAN}
NOISE_KERNELS = ('fused_sap_median_batched', 'fused_gaussian_blur',
                 'fused_mix_noise', 'fused_mix_bilateral', 'bloom_batched',
                 'bilateral_batched', 'threefry_draw')
GRID_TAPPED = {**TRAIN_TAPPED,
               'fused_mix_noise': (pipeline, 'fused_mix_noise',
                                   mk.fused_mix_noise_plain)}


def grid_row_kernels(noise) -> set:
    """The noise kernels a grid row's route must launch (and no others)."""
    fn = make_pipeline(noise)
    plan = noise if not isinstance(noise, str) else parse(noise)
    kind = plan.specs[0].kind
    if fn.backend == 'cuda:sap_median':
        return {'fused_sap_median_batched'}
    if fn.backend == 'cuda:gaussian_blur':
        return {'fused_gaussian_blur'}
    if fn.backend.startswith('cuda:fused_mix'):
        return {'fused_mix_bilateral' if 'bilateral' in fn.backend
                else 'fused_mix_noise'}
    want = {'threefry_draw'} if kind in THREEFRY_KINDS else set()
    if fn.backend.startswith('cuda:bilateral'):
        want.add('bilateral_batched')
    if kind == Kind.BLOOM:
        want.add('bloom_batched')
    return want


def hold_mix_to_plain(launches, path: str) -> float:
    """Kernel 6's launches against its plain version, per image by the
    kind it drew: bit-exact, or a mod-256 distance of 1 on at most 1e-3
    of the elements for the kinds through log/exp/cos (gaussian's floats
    within 1e-6)."""
    err = 0.0
    for a, k, got in launches:
        want = mk.fused_mix_noise_plain(*a, **k)
        kinds, branch = a[-1], a[1].tolist()
        for i, pos in enumerate(branch):
            kind = kinds[pos]
            d = (got[i] - want[i]).abs()
            if kind in TRANSCENDENTAL:
                d = d * 1e6 if kind == 1 else torch.minimum(d, 256.0 - d)
                ok = d.max().item() <= 1 and (
                    d > 0).double().mean().item() <= 1e-3
            else:
                ok = d.max().item() == 0
            if not ok:
                raise AssertionError(f'{path}: fused_mix_noise image {i} '
                                     f'(kind {kind}) differs from its plain '
                                     f'version ({d.max().item()})')
            err = max(err, d.max().item())
    return err


def grid_phase(card: str) -> dict:
    """The noise grid through the port, in process: `noise_grid.main` with
    res101 (seeded, full width and depth), the fixture at GRID_TRAIN
    train / GRID_TEST test images of 240x320 (seed 3), GRID_ITERS
    iterations with a snapshot every GRID_SNAPSHOT, every GRID string and
    the three control rows, under build/.  Each row: finite APs in [0, 1]; its route's noise
    kernels launched (and no others), kernel 3 and the walk twice a chunk;
    every launch held to its plain version.  The three gaus_blur rows
    equal.  A second call (one row) restores the finished snapshot and
    trains no step, and scores that row as the first did.  Then
    `cli.reval.main` on two rows' output dirs: without --nms exactly the
    row's APs, with --nms finite ones (kernel 3 and the walk launched,
    each launch held to its plain version)."""
    import os.path as osp
    import shutil

    import tpudenoise_torch.core.config as config
    from tpudenoise_torch.cli import reval
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.experiments import noise_grid as ng
    workdir = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_grid')
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ['--net', 'res101', '--iters', str(GRID_ITERS), '--n-train',
            str(GRID_TRAIN), '--n-test', str(GRID_TEST), '--workdir',
            workdir, '--out-md', osp.join(workdir, 'RESULTS.md'),
            '--out-json', osp.join(workdir, 'RESULTS.json')]
    rows_seen, aps_of, totals = {}, {}, {}

    def grid_config(fn):
        def call(*a, **k):
            cfg = fn(*a, **k)
            cfg.TRAIN.SNAPSHOT_ITERS = GRID_SNAPSHOT
            return cfg
        return call

    def record_aps(fn):
        def call(model, params, imdb, name, noise, **k):
            aps_of[name] = fn(model, params, imdb, name, noise, **k)
            return aps_of[name]
        return call

    def evaluate_row(fn):
        def call(model, params, cfg, net, noise, eval_batch, label=None):
            name = label or noise
            zero_counts()
            with taped(GRID_TAPPED) as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                row = fn(model, params, cfg, net, noise, eval_batch, label)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = launch_counts()
            chunks = -(-GRID_TEST // eval_batch)
            want = grid_row_kernels(noise)
            got = {k for k in NOISE_KERNELS if counts[k]}
            if got != want or any(counts[k] != 2 * chunks
                                  for k in NMS_KERNELS):
                raise AssertionError(f'grid row {name}: launches '
                                     f'{ {k: v for k, v in counts.items() if v} }'
                                     f', expected {sorted(want)} and '
                                     f'{2 * chunks} of each NMS kernel')
            t1 = time.perf_counter()
            mix = calls.pop('fused_mix_noise', None)
            held = hold_train_to_plain(calls, f'grid row {name}', card) \
                if calls else {}
            if mix:
                held['fused_mix_noise'] = dict(
                    launches=len(mix), max_abs_err=hold_mix_to_plain(
                        mix, f'grid row {name}'))
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            rows_seen[name] = dict(row=row, wall_s=wall,
                                   hold_s=time.perf_counter() - t1,
                                   launches={k: v for k, v in counts.items()
                                             if v})
            aps = row['AP@.5'], row['AP@[.5,.95]']
            if not all(np.isfinite(a) and 0 <= a <= 1 for a in aps):
                raise AssertionError(f'grid row {name}: APs {aps}')
            return row
        return call

    t0 = time.perf_counter()
    with patched(ng, 'grid_config', grid_config), \
            patched(ng, 'evaluate_row', evaluate_row), \
            patched(harness, 'test_net_batched', record_aps), \
            recording() as (seen, _):
        meta = ng.main(argv)
    wall = time.perf_counter() - t0
    if len(seen) != GRID_ITERS or not all(
            np.isfinite(v) for x in seen for v in x['losses'].values()):
        raise AssertionError(f'grid: {len(seen)} training steps seen')
    rows = meta['results']
    if [r['noise'] for r in rows[:len(ng.GRID)]] != ng.GRID or \
            len(rows) != len(ng.GRID) + len(ng.CONTROLS):
        raise AssertionError(f'grid: rows {[r["noise"] for r in rows]}')
    blur = [(r['AP@.5'], r['AP@[.5,.95]']) for r in rows
            if r['noise'].startswith('gaussian_gaus_blur')]
    if len(blur) != 3 or len(set(blur)) != 1:
        raise AssertionError(f'grid: the gaus_blur rows differ {blur}')
    hold_s = sum(r['hold_s'] for r in rows_seen.values())
    log(f'grid: trained res101 {GRID_ITERS} iterations in '
        f'{meta["train_s"]:.1f} s, swept {len(rows)} rows in '
        f'{meta["sweep_s"]:.1f} s ({hold_s:.1f} s of it holding launches '
        f'to their plain versions); phase {wall:.1f} s  [{card}]')
    log('grid rows (AP@.5, AP@[.5,.95], s): ' + '; '.join(
        f'{r["noise"]} {r["AP@.5"]:.4f} {r["AP@[.5,.95]"]:.4f} '
        f'{rows_seen[r["noise"]]["wall_s"]:.2f}' for r in rows))
    # the second call: one row, the finished snapshot restored
    with patched(ng, 'GRID', lambda grid: grid[:1]), \
            patched(ng, 'grid_config', grid_config), \
            recording() as (seen2, restored):
        meta2 = ng.main(argv)
    if seen2 or not restored or meta2['results'][0] != {
            **rows[0], 'eval_s': meta2['results'][0]['eval_s']}:
        raise AssertionError(f'grid second call: {len(seen2)} steps, '
                             f'{meta2["results"][0]} against {rows[0]}')
    # reval on two rows' output dirs
    cfg = ng.grid_config(workdir, GRID_ITERS)
    revals = {}

    def reval_main(argv_):
        config.cfg.DATA_DIR = cfg.DATA_DIR
        config.cfg.ROOT_DIR = cfg.ROOT_DIR
        return reval.main(argv_)

    for noise in ('sap_median_var0.4', 'gaussian_wavelet_var0.1'):
        name = f'res101_grid_{noise}'
        out_dir = get_output_dir('rrData_2021_test', name, cfg)
        base = [out_dir, '--imdb', 'rrData_2021_test', '--comp']
        aps, _, _, _ = run_cli(reval_main, base)
        if list(aps) != list(aps_of[name]):
            raise AssertionError(f'reval {noise}: {aps} against the row\'s '
                                 f'{aps_of[name]}')
        with taped() as calls:
            aps_nms, wall_nms, counts, _ = run_cli(reval_main,
                                                   base + ['--nms'])
        if not (counts[MASKS] and counts[WALK]) or not all(
                np.isfinite(a) and 0 <= a <= 1 for a in aps_nms):
            raise AssertionError(f'reval --nms {noise}: {aps_nms}, '
                                 f'launches {counts}')
        held = hold_to_plain(calls, f'reval --nms {noise}', card)
        revals[noise] = dict(aps=list(aps), aps_nms=list(aps_nms),
                             nms_s=wall_nms,
                             launches={MASKS: counts[MASKS],
                                       WALK: counts[WALK]}, held=held)
        log(f'reval {noise}: the row\'s APs exactly; --nms AP@.5 '
            f'{aps_nms[0]:.4f} (row {aps[0]:.4f}) in {wall_nms:.2f} s, '
            f'launches {json.dumps(revals[noise]["launches"])}  [{card}]')
    for r in revals.values():
        for k, v in r['launches'].items():
            totals[k] = totals.get(k, 0) + v
    return {'noise grid': dict(
        wall_s=wall, train_s=meta['train_s'], sweep_s=meta['sweep_s'],
        hold_s=hold_s, rows=rows_seen, reval=revals,
        launches={k: v for k, v in totals.items() if v})}


# the shape-diverse eval phase: VOC's and COCO's image shapes, cycled over
# numpy-written sets; the noise strings of each and the VOC pyramid
VOC_SHAPES = ((375, 500), (500, 375), (333, 500), (500, 333), (366, 500),
              (500, 400))
COCO_SHAPES = ((480, 640), (640, 480), (427, 640), (640, 427), (612, 612),
               (375, 500))
VOC_IMAGES, COCO_IMAGES = 32, 24
VOC_NOISES = ('sap_median_var0.4', 'brownian_var0.09', 'periodic_var100',
              'noise_mix_var_all', 'noise_mix_var_all_bilateral', 'bloom')
COCO_NOISES = ('gaussian_gaus_blur_var0.1', 'original')
PYRAMID_SCALES = (480, 600)
# test_net's four images: both orientations, giving the set's buckets
TEST_NET_IMAGES = (0, 1, 4, 5)
TEST_NET_NOISE = 'sap_median_var0.4'
SHAPE_TRAIN_NOISE = 'noise_mix_var_all'
# the kernels each run reports, and the noise kernels its bucketed route
# must launch (the mix scan never launches the fused mix kernels)
SHAPE_KERNELS = ('fused_sap_median_batched', 'fused_gaussian_blur', MASKS,
                 'bilateral_batched', 'bloom_batched', WALK, 'threefry_draw')
SHAPE_ROUTE = {'sap_median_var0.4': {'fused_sap_median_batched'},
               'gaussian_gaus_blur_var0.1': {'fused_gaussian_blur'},
               'brownian_var0.09': {'threefry_draw'},
               'periodic_var100': set(),
               'noise_mix_var_all': {'threefry_draw'},
               'noise_mix_var_all_bilateral': {'threefry_draw',
                                               'bilateral_batched'},
               'bloom': {'bloom_batched'},
               'original': set()}
# the card-vs-CPU chunks of the new routes: two images, shrunk; each
# route once (set, noise string, TEST.SCALES, loop)
SHAPE_SMALL = ((160, 200), (200, 160))
SHAPE_SMALL_CASES = (
    ('voc', 'sap_median_var0.4', (160,), 'batched'),
    ('voc', 'brownian_var0.09', (160,), 'batched'),
    ('voc', 'bloom', (160,), 'batched'),
    ('voc', 'noise_mix_var_all_bilateral', (128, 160), 'batched'),
    ('voc', 'periodic_var100', (160,), 'test_net'),
    ('coco', 'gaussian_gaus_blur_var0.1', (160,), 'batched'))


def shape_data(root: str, shapes, cfg) -> None:
    """The VOC2007 test and trainval sets (VOC_IMAGES images cycling
    `shapes[0]`) and the COCO minival set (COCO_IMAGES images cycling
    `shapes[1]`) under root, their `.npy` pixels where `get_imdb` looks,
    and VOC's image set test4 of TEST_NET_IMAGES."""
    import os.path as osp

    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    voc, coco = shapes
    for split in ('test', 'trainval'):
        synthetic.write_voc(root, voc, image_set=split, seed=31,
                            pixel_dir=default_pixel_dir(f'voc_2007_{split}',
                                                        cfg))
    synthetic.write_coco(root, coco, seed=32, pixel_dir=default_pixel_dir(
        'coco_2014_minival', cfg))
    with open(osp.join(root, 'VOCdevkit2007', 'VOC2007', 'ImageSets',
                       'Main', 'test4.txt'), 'w') as f:
        f.write(''.join(f'{i:06d}\n' for i in TEST_NET_IMAGES
                        if i < len(voc)))


def _loop_dets(imdb, name: str, cfg) -> list:
    """A loop's detections.pkl: per class, per image (K, 5)."""
    import os.path as osp
    import pickle
    with open(osp.join(get_output_dir(imdb.name, name, cfg),
                       'detections.pkl'), 'rb') as f:
        return pickle.load(f)


def _match_loops(want, got) -> tuple:
    """(matched, total) over every (class, image) of two loops'
    detections, at phase 4's tolerance."""
    matched = total = 0
    for a, g in zip(want[1:], got[1:]):
        m, t = _match_dets([np.asarray(x).reshape(-1, 5) for x in a],
                           [np.asarray(x).reshape(-1, 5) for x in g])
        matched, total = matched + m, total + t
    return matched, total


def check_shape_chunks(card: str) -> dict:
    """The new routes on a small input, card against CPU: two images
    (160x200 and 200x160, so two noise buckets) of a VOC and a COCO set,
    seeded vgg16 in f32 (21 and 81 classes), each route once
    (SHAPE_SMALL_CASES: kernel 1, the generic route and kernel 8 on
    canvases, the mix scan with kernel 5 under the pyramid's scales 128
    and 160, test_net, and COCO's kernel 2); >= 95% of the CPU's
    detections with a card twin (phase 4's tolerance)."""
    import os.path as osp
    import shutil

    from tpudenoise_torch.data.factory import get_imdb
    from tpudenoise_torch.eval.harness import test_net
    root = osp.join(default_config().ROOT_DIR, 'build',
                    'chip_smoke_shapes_small')
    shutil.rmtree(root, ignore_errors=True)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (160,), 200
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 256, 64
    shape_data(root, (SHAPE_SMALL, SHAPE_SMALL), cfg)
    loops = {'batched': test_net_batched, 'test_net': test_net}
    cases = [(ds, noise, scales, loops[loop])
             for ds, noise, scales, loop in SHAPE_SMALL_CASES]
    models = {}
    for ds, classes in (('voc', 21), ('coco', 81)):
        m = FasterRCNN('vgg16', num_classes=classes, cfg=cfg,
                       dtype=torch.float32)
        models[ds] = (m, seeded(m))
    dets = {}
    for d in ('cpu', DEV):
        for ds, (m, params) in models.items():
            m.to(d)
            models[ds] = (m, {k: v.to(d) for k, v in params.items()})
        for ds, noise, scales, loop in cases:
            m, params = models[ds]
            c = copy.deepcopy(cfg)
            c.TEST.SCALES = scales
            imdb = get_imdb('voc_2007_test' if ds == 'voc'
                            else 'coco_2014_minival', c)
            imdb.competition_mode(True)
            name = f'{loop.__name__}_{noise}_{len(scales)}_{d}'
            kw = {'eval_batch': 2} if loop is test_net_batched else {}
            loop(m, params, imdb, name, noise, config=c, **kw)
            dets[d, ds, noise, scales, loop.__name__] = _loop_dets(
                imdb, name, c)
    out = {}
    for ds, noise, scales, loop in cases:
        k = (ds, noise, scales, loop.__name__)
        matched, total = _match_loops(dets[('cpu',) + k], dets[(DEV,) + k])
        what = f'{ds} {loop.__name__} {noise} scales {scales}'
        log(f'small shape-diverse chunk {what}: {matched}/{total} CPU '
            f'detections have a card twin within 0.5 px  [{card}]')
        if total == 0 or matched / total < 0.95:
            raise AssertionError(f'{what}: card and CPU disagree')
        out[what] = [matched, total]
    return out


def one_chunk(model, params, imdb, noise: str, cfg):
    """A closure that runs a loop's first chunk on the card as
    test_net_batched builds it (the first image's orientation, up to B
    images of it, edge-padded to its noise bucket)."""
    from tpudenoise_torch.eval import harness
    shapes = harness._raw_shapes(imdb)
    buckets = harness.derive_noise_buckets(shapes)

    def orient(hw):
        return 'p' if hw[0] > hw[1] else 'l'

    o = orient(shapes[0])
    idx = [i for i, hw in enumerate(shapes) if orient(hw) == o][:B]
    raw = torch.from_numpy(np.stack([harness._pad_raw_to_bucket(
        read_bgr(imdb.image_path_at(i)), buckets[o]) for i in idx])).to(DEV)
    hw = [shapes[i] for i in idx]
    levels = harness.chunk_levels(hw, cfg.TEST.SCALES, cfg.TEST.MAX_SIZE,
                                  None, DEV)
    fn, key = make_pipeline(noise), prng.PRNGKey(cfg.RNG_SEED)

    def run():
        return harness.detect_chunk(model, params, key, idx, raw, levels,
                                    fn, hw)

    return run


def idle_shares(runs: dict) -> dict:
    """Each run once warm, then once more each in one torch.profiler
    session of the device's activity only (no host events to parse), each
    run after a marker kernel (`timing.MARKER`) and closed by a
    synchronize, two markers at either edge (a trace can drop a record at
    its edge): per run its wall ms, the device ms of the kernels between
    its marker and the next, and the device's idle share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marks = [time.perf_counter()]
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    walls = {}
    marks.append(time.perf_counter())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marks.append(time.perf_counter())
        torch.cuda._sleep(1)
        for name, run in runs.items():
            torch.cuda._sleep(1)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
        for _ in range(2):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks.append(time.perf_counter())
    log('idle shares: ' + ', '.join(
        f'{k} {b - a:.2f} s' for k, a, b in zip(
            ('warm chunks', 'profiler start', 'profiled chunks',
             'profiler stop and parse'), marks, marks[1:])))
    groups, group = [], None
    for e in kernels:
        if MARKER in e.name:
            if group:
                groups.append(group)
            group = []
        elif group is not None:
            group.append(e.time_range.elapsed_us())
    if len(groups) != len(runs):
        raise AssertionError(f'idle shares: the trace splits into '
                             f'{len(groups)} runs, not {len(runs)}')
    out = {}
    for (name, wall), group in zip(walls.items(), groups):
        busy = sum(group) / 1e3
        out[name] = dict(wall_ms=wall, device_ms=busy,
                         idle_share=1.0 - busy / wall)
    return out


def shape_run(card: str, model, params, imdb, noise: str, cfg, name: str,
              loop=test_net_batched) -> dict:
    """One loop over a shape-diverse set on the card: the launch counters
    zeroed before and read after, every launch taped and held to its
    plain version; the route's noise kernels launched and no fused mix
    kernel, kernel 3 and the walk once a forward and once a chunk's
    postprocess; finite APs (VOC) or 12 finite COCO stats."""
    import os.path as osp
    import pickle

    from tpudenoise_torch.eval import harness
    zero_counts()
    with taped(TRAIN_TAPPED) as calls:
        kw = {'eval_batch': B} if loop is test_net_batched else {}
        aps, wall = _timed(lambda: loop(model, params, imdb, name, noise,
                                        config=cfg, **kw))
    counts = launch_counts()
    shapes = harness._raw_shapes(imdb)
    buckets = harness.derive_noise_buckets(shapes)
    per = {}
    for h, w in shapes:
        o = 'p' if h > w else 'l'
        per[o] = per.get(o, 0) + 1
    chunks = (sum(-(-n // B) for n in per.values())
              if loop is test_net_batched else len(shapes))
    n_nms = chunks * (len(cfg.TEST.SCALES) + 1)
    path = f'shapes {name}'
    want = SHAPE_ROUTE[noise]
    if (any(not counts[k] for k in want) or counts['fused_mix_noise']
            or counts['fused_mix_bilateral']
            or counts[MASKS] != n_nms or counts[WALK] != n_nms):
        raise AssertionError(f'{path}: launches {counts}, expected '
                             f'{sorted(want)} and {n_nms} of each NMS '
                             f'kernel')
    t1 = time.perf_counter()
    held = hold_train_to_plain(calls, path, card)
    hold_s = time.perf_counter() - t1
    del calls
    out_dir = get_output_dir(imdb.name, name, cfg)
    if imdb.name.startswith('coco'):
        with open(osp.join(out_dir, 'detection_results.pkl'), 'rb') as f:
            scores = [float(v) for v in pickle.load(f).stats]
        if len(scores) != 12 or not np.isfinite(scores).all():
            raise AssertionError(f'{path}: COCO stats {scores}')
    else:
        scores = [float(a) for a in aps]
        if len(scores) != 20 or not all(np.isfinite(a) and 0 <= a <= 1
                                        for a in scores):
            raise AssertionError(f'{path}: APs {scores}')
    launches = {k: counts[k] for k in SHAPE_KERNELS}
    entry = dict(images=len(shapes), buckets=buckets, chunks=chunks,
                 wall_s=wall, img_per_s=len(shapes) / wall, hold_s=hold_s,
                 scores=scores, launches=launches, held=held,
                 kinds=kinds_drawn(noise, prng.PRNGKey(cfg.RNG_SEED),
                                   range(len(shapes))))
    log(f'{path}: {len(shapes)} images, buckets {buckets}, {chunks} '
        f'chunks, scales {tuple(cfg.TEST.SCALES)}, {wall:.2f} s '
        f'({len(shapes) / wall:.1f} img/s, read and evaluation included); '
        + ('COCO stats ' if imdb.name.startswith('coco') else 'mAP ')
        + f'{np.mean(scores) if len(scores) == 20 else scores[0]:.4f}; '
        f'launches {json.dumps(launches)}'
        + (f'; kinds {json.dumps(entry["kinds"])}' if entry['kinds']
           else '') + f'  [{card}]')
    return entry


def shape_phase(card: str, rows: list) -> dict:
    """Evaluation on datasets of many image shapes, at full width: a
    seeded res101 (bf16, full depth) over a numpy-written VOC2007 test
    set (VOC_IMAGES images in VOC's shapes) on each VOC_NOISES string,
    over a COCO minival set (COCO_IMAGES images in COCO's shapes, 81
    classes) on COCO_NOISES, and the VOC set again on `original` under
    TEST.SCALES = PYRAMID_SCALES; eval batch B, TEST scale 600 and
    MAX_SIZE 1000, detection buckets 608x1024 and 1024x608, the noise in
    per-orientation buckets.  Then test_net on TEST_NET_IMAGES against
    test_net_batched on the same four images (phase 4's tolerance), and
    one res101 training step on the VOC trainval set with
    SHAPE_TRAIN_NOISE (its batch through the masked mix scan; finite
    losses).  Every launch held to its plain version (`shape_run`); kernel
    3 and the walk timed at the pyramid's and COCO's postprocess shapes;
    each run's first chunk profiled for the device's idle share after
    the timed runs."""
    import os.path as osp
    import shutil

    from tpudenoise_torch.cli import trainval
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.factory import get_imdb
    from tpudenoise_torch.data.voc_like import pascal_voc
    from tpudenoise_torch.eval.harness import test_net
    t_phase = time.perf_counter()
    marks = [t_phase]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    parts = {}
    small = check_shape_chunks(card)
    parts['small chunks'] = lap()
    repo = default_config().ROOT_DIR
    root = osp.join(repo, 'build', 'chip_smoke_shapes')
    shutil.rmtree(root, ignore_errors=True)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    voc_shapes = [VOC_SHAPES[i % len(VOC_SHAPES)] for i in range(VOC_IMAGES)]
    coco_shapes = [COCO_SHAPES[i % len(COCO_SHAPES)]
                   for i in range(COCO_IMAGES)]
    shape_data(root, (voc_shapes, coco_shapes), cfg)
    voc = get_imdb('voc_2007_test', cfg)
    coco = get_imdb('coco_2014_minival', cfg)
    for d in (voc, coco):
        d.competition_mode(True)
        if not d.image_path_at(0).endswith('.npy'):
            raise AssertionError(f'{d.name}: not on its cached pixels')
    parts['data'] = lap()
    models = {}
    for ds, n in (('voc', voc.num_classes), ('coco', coco.num_classes)):
        m = FasterRCNN('res101', num_classes=n, cfg=default_config())
        params = seeded(m)
        m.to(DEV)
        models[ds] = (m, {k: v.to(DEV) for k, v in params.items()})
    parts['models'] = lap()
    runs, chunk_fns = {}, {}
    pyr = copy.deepcopy(cfg)
    pyr.TEST.SCALES = PYRAMID_SCALES
    plan = ([('voc', voc, n, cfg) for n in VOC_NOISES]
            + [('coco', coco, n, cfg) for n in COCO_NOISES]
            + [('voc', voc, 'original', pyr)])
    for ds, imdb, noise, c in plan:
        name = (f'{ds} {noise}' + (f' scales {PYRAMID_SCALES}'
                                   if c is pyr else ''))
        m, params = models[ds]
        runs[name] = shape_run(card, m, params, imdb, noise, c,
                               name.replace(' ', '_'))
        chunk_fns[name] = one_chunk(m, params, imdb, noise, c)
    parts['runs'] = lap()

    # kernel 3 and the walk at the pyramid's and COCO's postprocess
    # shapes: a first-chunk postprocess NMS launch each, timed
    for name, key in ((f'voc original scales {PYRAMID_SCALES}',
                       'pyramid_post'), ('coco original', 'coco_post')):
        with taped({MASKS: TAPPED[MASKS], WALK: TAPPED[WALK]}) as calls:
            chunk_fns[name]()
        nms_rows(calls, rows, card, key, name,
                 pick=lambda launches: max(launches,
                                           key=lambda c: c[0][0].shape[0]))
    parts['nms rows'] = lap()

    # test_net on four images against test_net_batched on the same four
    sub = pascal_voc('test4', '2007', config=cfg,
                     pixel_dir=default_pixel_dir('voc_2007_test', cfg))
    sub.competition_mode(True)
    m, params = models['voc']
    e1 = shape_run(card, m, params, sub, TEST_NET_NOISE, cfg,
                   'test_net_sub', loop=test_net)
    e2 = shape_run(card, m, params, sub, TEST_NET_NOISE, cfg,
                   'test_net_batched_sub')
    matched, total = _match_loops(_loop_dets(sub, 'test_net_batched_sub',
                                             cfg),
                                  _loop_dets(sub, 'test_net_sub', cfg))
    if total == 0 or matched / total < 0.95:
        raise AssertionError(f'test_net: {matched}/{total} detections '
                             f'match test_net_batched')
    log(f'test_net on {sub.num_images} VOC images: {matched}/{total} of '
        f'test_net_batched\'s detections have a twin within 0.5 px  '
        f'[{card}]')
    runs[f'test_net {TEST_NET_NOISE}'] = {**e1, 'matched': [matched, total]}
    runs[f'test_net_batched 4 images {TEST_NET_NOISE}'] = e2
    parts['test_net'] = lap()

    # one training step on the VOC trainval set through the mix scan
    argv = ['--net', 'res101', '--cfg', osp.join(repo, 'experiments', 'cfgs',
                                                 'res101.yml'),
            '--imdb', 'voc_2007_trainval', '--imdbval', 'voc_2007_trainval',
            '--iters', '1', '--noise', SHAPE_TRAIN_NOISE, '--tag', 'shapes',
            '--set', 'DATA_DIR', root, 'ROOT_DIR', root, 'TRAIN.DISPLAY',
            '1', 'TRAIN.SNAPSHOT_ITERS', '3']
    masked = []
    with taped(TRAIN_TAPPED) as calls, recording() as (seen, _), \
            patched(pipeline._PerImagePipeline, 'masked',
                    lambda fn: lambda self, *a: masked.append(
                        self.backend) or fn(self, *a)):
        _, wall, counts, _ = run_cli(trainval.main, argv)
    path = f'shapes train res101 {SHAPE_TRAIN_NOISE}'
    losses = [x['losses'] for x in seen]
    if len(seen) != 1 or set(masked) != {'cuda:fused_mix'} or not all(
            np.isfinite(v) for x in losses for v in x.values()):
        raise AssertionError(f'{path}: {len(seen)} steps, masked '
                             f'{masked}, losses {losses}')
    if counts[MASKS] != 1 or counts[WALK] != 1 or \
            counts['threefry_draw'] < TRAIN_DRAWS['res101']:
        raise AssertionError(f'{path}: launches {counts}')
    held = hold_train_to_plain(calls, path, card)
    del calls
    launches = {k: counts[k] for k in SHAPE_KERNELS}
    log(f'{path}: 1 step in {wall:.2f} s (main()), its batch through the '
        f'masked mix scan; total_loss {losses[0]["total_loss"]:.4f}; '
        f'launches {json.dumps(launches)}  [{card}]')
    runs['train res101 1 step'] = dict(wall_s=wall, losses=losses,
                                       launches=launches, held=held)
    parts['train step'] = lap()

    # after every timed run: each run's first chunk, profiled
    for name, r in idle_shares(chunk_fns).items():
        runs[name]['chunk'] = r
        log(f'shapes {name}: first chunk {r["wall_ms"]:.2f} ms, device '
            f'{r["device_ms"]:.2f} ms, idle {r["idle_share"]:.1%}  '
            f'[{card}]')
    parts['idle shares'] = lap()
    totals = {}
    for r in runs.values():
        for k, v in r['launches'].items():
            totals[k] = totals.get(k, 0) + v
    missing = [k for k in SHAPE_KERNELS if not totals.get(k)]
    if missing:
        raise AssertionError(f'shape-diverse eval: {missing} never launched')
    wall = time.perf_counter() - t_phase
    log(f'shape-diverse eval phase: {wall:.1f} s ('
        + ', '.join(f'{k} {v:.1f}' for k, v in parts.items())
        + f'); launches {json.dumps(totals)}  [{card}]')
    return {'shape-diverse eval': dict(wall_s=wall, parts_s=parts,
                                       small=small, runs=runs,
                                       launches=totals)}


# ------------------------------------------------ slice 15: phase 5e --

# the --fast-rng strings of phase 5e and the kernels each chunk of 8
# launches: the hash draws the salts imply (poisson: its inversion
# uniform, fallback normal and 4 PTRS words; gamma: a normal and a
# uniform a round, 4 rounds; brownian and speckle one normal field)
FAST_KERNELS = {'poisson': {'hash_draw': 6},
                'gamma_var0.3': {'hash_draw': 8},
                'brownian_var0.09': {'hash_draw': 1},
                'speckle_bilateral_var1.0': {'hash_draw': 1,
                                             'bilateral_batched': 2}}
FAST_TRAIN_NOISE = 'poisson'
# the curvelet chunks (1 warm, 2 timed) and the card-vs-CPU case
CURVELET_CHUNKS = 3
CURVELET_SMALL = (2, 160, 200, 3)
CURVELET_SHARE = 5e-3


def hold_hash_to_plain(calls, path: str, card: str) -> dict:
    """Each recorded hash_draw launch against its plain version on the
    same seeds: words and uniforms bit-exact, normals within 2 ulp."""
    worst = 0
    for a, _, got in calls:
        want = prng.hash_draw_plain(*a)
        e = (got.view(torch.int32).long()
             - want.view(torch.int32).long()).abs().max().item()
        if e > (2 if a[3] == 'normal' else 0):
            raise AssertionError(f'{path}: hash_draw {a[3]} salt {a[2]} '
                                 f'{e} ulp from its plain version')
        worst = max(worst, e)
    modes = sorted({(a[2], a[3]) for a, _, _ in calls})
    log(f'{path}: hash_draw held to its plain version on its {len(calls)} '
        f'launches (salt, mode) {modes}: max {worst} ulp  [{card}]')
    return dict(launches=len(calls), salts=modes, max_ulp=worst)


def fast_rng_paths(res, card: str) -> dict:
    """`--fast-rng` on the res101 main path: each FAST_KERNELS string's
    chunks with and without the flag (the flag's hash launches and no
    threefry draw), one more chunk of each with every hash launch held
    to its plain version, and sap_median_var0.4 with the flag giving the
    bytes it gives without."""
    noises = tuple(FAST_KERNELS)
    out = main_path(res, card, noises, 'res101 ')
    out.update(main_path(res, card, noises, 'res101 ', fast=True))
    for noise in noises:
        a, b = out[f'res101 {noise}'], out[f'res101 {noise} --fast-rng']
        log(f'--fast-rng {noise}: {b["img_per_s"]:.1f} img/s against '
            f'{a["img_per_s"]:.1f} without; noise ms '
            f'{b["stage_ms"]["noise"]:.2f} against '
            f'{a["stage_ms"]["noise"]:.2f}  [{card}]')
    model, params, raw, levels, key = res
    tapped = {'hash_draw': (prng, 'hash_draw', prng.hash_draw_plain)}
    for noise in noises:
        with taped(tapped) as calls:
            noise_chunk(key, list(range(B)), raw,
                        make_pipeline(noise, fast_rng=True))
        out[f'res101 {noise} --fast-rng']['held'] = hold_hash_to_plain(
            calls['hash_draw'], f'{noise} --fast-rng chunk', card)
        del calls
    idx = list(range(B))
    sap = [noise_chunk(key, idx, raw, make_pipeline('sap_median_var0.4',
                                                    fast_rng=f))
           for f in (False, True)]
    if not torch.equal(*sap):
        raise AssertionError('sap_median_var0.4 --fast-rng changed its bytes')
    log('sap_median_var0.4: the same bytes with --fast-rng and without '
        '(the fused route draws its own coordinate hash)')
    return out


def fast_rng_train(card: str) -> dict:
    """One cli.trainval --fast-rng step on the training phase's images:
    res101 on FAST_TRAIN_NOISE (the masked generic route's hash draws),
    finite losses, its hash launches as the salts imply and held to
    their plain version, the targets' threefry draws only."""
    import os.path as osp
    repo = default_config().ROOT_DIR
    inp = dict(repo=repo, root=osp.join(repo, 'build', 'chip_smoke_train'))
    e, *_ = train_cli(card, inp, 'res101', FAST_TRAIN_NOISE, 1, 'fast_rng',
                      fast=True)
    return {f'train res101 {FAST_TRAIN_NOISE} --fast-rng': e}


def curvelet_path(res, card: str) -> dict:
    """The curvelet string through detect_chunk on the res101 main path:
    kernel 6 (its 12-entry pre-noise), then the curvelet post-pass
    (`torch.fft`), 4 images a pass; CURVELET_CHUNKS chunks (the first
    builds the windows), the post-pass timed by CUDA events, the
    chunk's peak memory; the counters zeroed before and read after.
    Then CURVELET_SMALL card against CPU."""
    from tpudenoise_torch.denoise.curvelet import curvelet_denoise_batched
    model, params, raw, levels, key = res
    noise = 'curvelet'
    noise_fn = make_pipeline(noise)
    post_ms, walls, peaks = [], [], []

    def timed_post(fn):
        def call(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            y = fn(*a, **k)
            ev[1].record()
            post_ms.append(ev)
            return y
        return call

    zero_counts()
    with patched(pipeline, 'curvelet_denoise_batched', timed_post):
        for it in range(CURVELET_CHUNKS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            boxes, scores, mask = detect_chunk(
                model, params, key, list(range(B * it, B * it + B)), raw,
                levels, noise_fn)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
    counts = launch_counts()
    launches = {k: counts[k] for k in ('fused_mix_noise',) + NMS_KERNELS}
    if launches != {'fused_mix_noise': CURVELET_CHUNKS,
                    MASKS: 2 * CURVELET_CHUNKS, WALK: 2 * CURVELET_CHUNKS}:
        raise AssertionError(f'{noise}: launches {launches}')
    kept = mask.cpu().numpy()
    if not kept.any() or not np.isfinite(boxes.cpu().numpy()).all():
        raise AssertionError(f'{noise}: no finite detections kept')
    ms = [a.elapsed_time(b) for a, b in post_ms]
    rng = np.random.RandomState(16)
    small = torch.from_numpy(rng.randint(0, 256, CURVELET_SMALL).astype(
        np.uint8))
    d = (curvelet_denoise_batched(small.to(DEV)).cpu()
         - curvelet_denoise_batched(small)).abs()
    share = (d > 0).double().mean().item()
    if d.max() > 1 or share > CURVELET_SHARE:
        raise AssertionError(f'curvelet card vs CPU: max {d.max()}, '
                             f'share {share}')
    log(f'main path res101 {noise}: chunks '
        f'{[f"{w * 1e3:.1f}" for w in walls]} ms (the first builds the '
        f'windows); the curvelet post-pass '
        f'{[f"{t:.2f}" for t in ms]} ms by CUDA events; peak memory above '
        f'the model {[f"{p / 2**30:.2f}" for p in peaks]} GiB; launches '
        f'{json.dumps(launches)}; card vs CPU at {CURVELET_SMALL}: max '
        f'|diff| {d.max().item():.0f}, changed {share:.2e}  [{card}]')
    return {f'res101 {noise}': dict(
        chunk_ms=[w * 1e3 for w in walls], post_ms=ms,
        peak_gib=[p / 2**30 for p in peaks], launches=launches,
        img_per_s=B / statistics.median(walls[1:]),
        small_max_abs_err=d.max().item(), small_changed=share)}


def fdct_cli(card: str) -> dict:
    """`python -m tpudenoise_torch.cli.fdct` in process on one 600x1000
    `.npy` image: the written `.npy` is the returned (H, W, 3) u8."""
    import os.path as osp
    from tpudenoise_torch.cli import fdct
    root = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_fdct')
    os.makedirs(root, exist_ok=True)
    src, dst = osp.join(root, 'in.npy'), osp.join(root, 'out.npy')
    np.save(src, _demo_image(np.random.RandomState(17), H, W))
    zero_counts()
    got, wall = _timed(fdct.main, ['gaussian_var1.0', src, '--out', dst])
    written = np.load(dst)
    if written.shape != (H, W, 3) or written.dtype != np.uint8 or not \
            np.array_equal(written, got.astype(np.uint8)):
        raise AssertionError(f'cli.fdct wrote {written.shape} '
                             f'{written.dtype}')
    launches = {'threefry_draw': launch_counts()['threefry_draw']}
    log(f'cli.fdct gaussian_var1.0 on a {H}x{W} .npy: wrote {dst} in '
        f'{wall:.2f} s; launches {json.dumps(launches)}  [{card}]')
    return {'cli.fdct': dict(wall_s=wall, launches=launches)}


def randomized_resnet(net: str, seed: int = 15,
                      num_classes: int = 2) -> dict:
    """The seeded res101 of rrData's two classes (or num_classes) with
    every conv3 kernel and BN statistic of its head drawn at random: the
    seeded init zeroes conv3, which would leave every probe reading
    zeros."""
    model = FasterRCNN(net, num_classes=num_classes)
    params = seeded(model)
    rng = np.random.RandomState(seed)
    for name, p in params.items():
        if not name.startswith('head.'):
            continue
        if name.endswith('conv3.weight'):
            std = 0.3 / np.sqrt(p[0].numel())
            p.copy_(torch.from_numpy(rng.randn(*p.shape) * std))
        elif name.rsplit('.', 1)[-1] in ('gamma', 'var'):
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
        elif name.rsplit('.', 1)[-1] in ('beta', 'mean'):
            p.copy_(torch.from_numpy(rng.randn(*p.shape) * 0.1))
    return params


def compute_id_cli(card: str, inp: dict) -> dict:
    """cli.test --compute-id over the CLI phase's 16 rrData images, res101
    with a randomized head (`randomized_resnet`), --eval-batch 8: the
    per-layer TwoNN report logged for every probe and 'head', each ID
    finite and positive; the loop timed with and without the probes."""
    import os.path as osp

    from tpudenoise_torch.analysis.twonn import PROBES
    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.convert import save_params_npz
    root = inp['root']
    npz = osp.join(root, 'res101_probes.npz')
    save_params_npz(randomized_resnet('res101'), npz)
    argv = ['--net', 'res101', '--cfg', osp.join(
        inp['repo'], 'experiments', 'cfgs', 'res101.yml'),
        '--imdb', 'rrData_2021_test', '--noise', LOOP_NOISE,
        '--eval-batch', str(B), '--model', npz,
        '--set', 'DATA_DIR', root, 'ROOT_DIR', root]
    logged, loops, out = {}, {}, {}

    def logger():
        class Tee:
            active_sinks = False

            def log(self, metrics, step=None):
                logged.update(metrics)
        return Tee()

    for flag in ((), ('--compute-id',)):
        loop = []
        with patched(harness, 'test_net_batched',
                     lambda fn: timing(fn, loop)), \
                patched(harness, 'get_metrics_logger', lambda fn: logger):
            aps, wall, counts, _ = run_cli(cli_test.main, list(flag) + argv)
        if len(aps) != 10 or not all(np.isfinite(a) for a in aps):
            raise AssertionError(f'cli.test {flag}: APs {aps}')
        chunks = CLI_IMAGES // B
        launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                    + NMS_KERNELS}
        if launches != {'fused_sap_median_batched': chunks,
                        MASKS: 2 * chunks, WALK: 2 * chunks}:
            raise AssertionError(f'cli.test {flag}: launches {launches}')
        loops[bool(flag)] = loop[0]
        out['cli.test --compute-id' if flag else 'cli.test (probe weights)'] \
            = dict(wall_s=wall, eval_s=loop[0], launches=launches)
    want = [f'twonn_id/{p}' for p in PROBES['res101'] + ['head']]
    ids = {k: logged.get(k) for k in want}
    if not all(v is not None and np.isfinite(v) and v > 0
               for v in ids.values()):
        raise AssertionError(f'--compute-id: IDs {ids}')
    out['cli.test --compute-id']['twonn_id'] = ids
    log(f'cli.test --compute-id res101 over {CLI_IMAGES} images: the loop '
        f'{loops[True]:.2f} s against {loops[False]:.2f} s without probes '
        f'({loops[True] / loops[False]:.2f}x); IDs '
        + ', '.join(f'{k[9:]} {v:.2f}' for k, v in ids.items())
        + f'  [{card}]')
    return out


def slice15_phase(card: str, res, cli: dict) -> dict:
    """Phase 5e: `--fast-rng` on the res101 main path and in one training
    step, the curvelet string through detect_chunk and `cli.fdct`, and
    `cli.test --compute-id`."""
    out = fast_rng_paths(res, card)
    out.update(fast_rng_train(card))
    out.update(curvelet_path(res, card))
    out.update(fdct_cli(card))
    out.update(compute_id_cli(card, cli))
    return out


# ------------------------------------------------ slice 16: phase 5f --

# the mobile chunks' noise strings (kernels 1 and 2)
MOBILE_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1')
# the Automold images: AUTOMOLD_B of the main path's size, and the
# card-against-CPU pair; bounds as tests/test_torch_automold.py's
AUTOMOLD_B = 8
AUTOMOLD_SMALL = (2, 120, 160, 3)
AUTOMOLD_FAR, AUTOMOLD_NEAR = 1e-3, 1e-2


def randomize_bn(params: dict, seed: int) -> dict:
    """params with every BN statistic drawn at random (gamma and var in
    [0.5, 1.5], beta and mean N(0, 0.1)), in place: a seeded backbone's
    BN is the identity, and mobile's ReLU6 would then clamp most of what
    the card and the CPU differ in."""
    rng = np.random.RandomState(seed)
    for name, p in params.items():
        leaf = name.rsplit('.', 1)[-1]
        if leaf in ('gamma', 'var'):
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
        elif leaf in ('beta', 'mean'):
            p.copy_(torch.from_numpy(rng.randn(*p.shape) * 0.1))
    return params


def mobile_head_times(mob, card: str) -> dict:
    """The mobile head on the chunk's bucket (8, 3, 608, 1024) bf16 in
    channels-last memory, by CUDA events (2 warm, 5 timed): the whole
    head, and each layer's convs (the full conv, the depthwise 3x3 and
    the pointwise 1x1) and BN + ReLU6 apart, on that layer's input."""
    from tpudenoise_torch.models.backbones.mobilenet import relu6
    from tpudenoise_torch.models.rpn import conv
    model = mob[0]
    head = model.head
    x = torch.zeros(B, *BUCKET, 3, device=DEV).normal_().mul_(50).permute(
        0, 3, 1, 2)

    def ms(fn, *a):
        return time_ms(lambda: fn(*a), 5)

    parts = {'depthwise': 0.0, 'pointwise': 0.0, 'full conv': 0.0,
             'bn + relu6': 0.0}
    with torch.no_grad():
        whole = ms(head, x)
        h = x.to(head.dtype)
        for layer in head.children():
            if hasattr(layer, 'depthwise'):
                d = conv(h, layer.depthwise, head.dtype, layer.stride)
                parts['depthwise'] += ms(conv, h, layer.depthwise,
                                         head.dtype, layer.stride)
                a = relu6(layer.dw_bn(d))
                parts['bn + relu6'] += ms(lambda t: relu6(layer.dw_bn(t)), d)
                p = conv(a, layer.pointwise, head.dtype)
                parts['pointwise'] += ms(conv, a, layer.pointwise,
                                         head.dtype)
                parts['bn + relu6'] += ms(lambda t: relu6(layer.pw_bn(t)), p)
                h = relu6(layer.pw_bn(p))
            else:
                c = conv(h, layer.conv, head.dtype, layer.stride)
                parts['full conv'] += ms(conv, h, layer.conv, head.dtype,
                                         layer.stride)
                parts['bn + relu6'] += ms(lambda t: relu6(layer.bn(t)), c)
                h = relu6(layer.bn(c))
    log(f'mobile head on ({B}, 3, {BUCKET[0]}, {BUCKET[1]}) bf16: '
        f'{whole:.2f} ms by CUDA events; layer by layer (ms, summed over '
        f'the 12 layers): ' + ', '.join(f'{k} {v:.2f}'
                                         for k, v in parts.items())
        + f'  [{card}]')
    return dict(head_ms=whole, parts_ms=parts)


def mobile_paths(card: str, mob) -> dict:
    """The seeded mobile (bf16, DEPTH_MULTIPLIER 1.0, all 14 layers) on
    the main path: MOBILE_NOISES' chunks as main_path times them, every
    launch held to its plain version; the head's time split; one small
    chunk (f32, BN randomized) card against CPU."""
    with taped() as calls:
        out = main_path(mob, card, MOBILE_NOISES, 'mobile ')
    held = hold_to_plain(calls, 'mobile chunks', card)
    del calls
    out['mobile head'] = mobile_head_times(mob, card)
    out['mobile head']['launches'] = {}
    out['mobile chunks held'] = dict(held=held, launches={})
    out['mobile small chunk'] = mobile_small_chunk(card)
    return out


# the mobile small chunk, card (f32) against CPU: its forward outputs
# (bbox_pred within two bf16 ulps of its largest: the heads run in bf16)
MOBILE_ROI_PX, MOBILE_PROB_TOL, MOBILE_DELTA_TOL = 0.1, 1e-3, 2.0 ** -7


def mobile_small_chunk(card: str) -> dict:
    """small_chunks' inputs (two 120x200 frames, sap) through a seeded
    f32 mobile with its BN randomized, on the CPU and on the card, held
    in two parts.  The forward: the same roi_mask, each CPU roi with a
    card twin within MOBILE_ROI_PX, cls_prob within MOBILE_PROB_TOL (the
    class heads run in bf16) and bbox_pred within MOBILE_DELTA_TOL of
    its largest magnitude.  The postprocess: run on the CPU over the
    card's forward outputs, the same kept detections and scores as the
    card's, boxes within 1e-3 px.  Phase 4's detection-twin share is
    logged, not held: on these frames the seeded mobile scores its 300
    rois per class within ~0.01, so nearly every gap between two sorted
    class scores is below the card-CPU difference of the bf16 heads,
    and the per-class NMS then keeps another member of a cluster of
    near-equal boxes (the forward and the postprocess agree; the order
    of near-ties does not)."""
    from tpudenoise_torch.eval import harness
    model = FasterRCNN('mobile', num_classes=21, cfg=default_config(),
                       dtype=torch.float32)
    params = randomize_bn(seeded(model), 16)
    rng = np.random.RandomState(4)
    raw = torch.from_numpy(rng.randint(0, 256, (2, 120, 200, 3)).astype(
        np.uint8))
    geom = torch.tensor([[120, 200, 120, 200, 1.0]] * 2)
    fwd, det = {}, {}
    for d in ('cpu', DEV):
        model.to(d)
        p = {k: v.to(d) for k, v in params.items()}

        def forward(fn, d=d):
            def call(*a):
                out = fn(*a)
                fwd[d] = {k: v.cpu() for k, v in out.items()}
                return out
            return call

        with patched(model, 'forward_test', forward):
            det[d] = [t.cpu() for t in detect_chunk(
                model, p, prng.PRNGKey(3), [0, 1], raw.to(d),
                [(geom.to(d), (128, 224))], make_pipeline(
                    'sap_median_var0.4'))]
    c, g = fwd['cpu'], fwd[DEV]
    roi_px = max((a[:, None] - b[None]).abs().amax(-1).amin(1).max().item()
                 for a, b in zip(c['rois'], g['rois']))
    prob = (c['cls_prob'] - g['cls_prob']).abs().max().item()
    delta = ((c['bbox_pred'] - g['bbox_pred']).abs().max()
             / c['bbox_pred'].abs().max()).item()
    if (not torch.equal(c['roi_mask'], g['roi_mask'])
            or roi_px > MOBILE_ROI_PX or prob > MOBILE_PROB_TOL
            or delta > MOBILE_DELTA_TOL):
        raise AssertionError(f'mobile small chunk forward: rois {roi_px} '
                             f'px, cls_prob {prob}, bbox_pred {delta}')
    post = harness.postprocess_detections_pyramid(
        g['rois'][:, None], g['roi_mask'][:, None], g['cls_prob'][:, None],
        g['bbox_pred'][:, None], geom[:, None, 2:], model.num_classes,
        model.cfg.TEST.NMS, 0.0, max_per_class=100)
    (pb, ps, pm), (gb, gs, gm) = post, det[DEV]
    if not (torch.equal(pm, gm) and torch.equal(ps, gs)
            and (pb - gb).abs().max() <= 1e-3):
        raise AssertionError('mobile small chunk: the CPU postprocess of the '
                             'card forward keeps other detections')
    sc = c['cls_prob'][..., 1:].sort(1).values
    below = ((sc[:, 1:] - sc[:, :-1]) < prob).double().mean().item()
    (cb, cs_, cm) = (t.numpy() for t in det['cpu'])
    (gb_, gs_, gm_) = (t.numpy() for t in det[DEV])
    matched = total = 0
    for i in range(2):
        for k in range(cb.shape[1]):
            a, b = _dets(cb, cs_, cm, i, k), _dets(gb_, gs_, gm_, i, k)
            for row in a:
                total += 1
                matched += bool(b.size and np.abs(b - row).max(1).min() < 0.5)
    log(f'small chunk mobile sap_median_var0.4 (f32, BN randomized): forward '
        f'card vs CPU rois {roi_px:.2e} px, cls_prob {prob:.2e}, bbox_pred '
        f'{delta:.2e} of its largest; the CPU postprocess of the card '
        f'forward keeps the card\'s detections; {matched}/{total} CPU '
        f'detections with a card twin within 0.5 px ({below:.1%} of the '
        f'gaps between sorted class scores below the cls_prob difference)'
        f'  [{card}]')
    return dict(roi_px=roi_px, cls_prob=prob, bbox_pred=delta,
                twins=(matched, total), gaps_below=below, launches={})


def mobile_train(card: str) -> dict:
    """One cli.trainval --net mobile step on the training phase's images
    (kernel 1, the targets' threefry draws, kernel 3 and the walk, each
    launch held to its plain version): finite losses; every parameter
    that frozen_param_filter freezes (the head's first FIXED_LAYERS
    layers) bit-equal after the step, the other head layers, the RPN,
    the tail (its BN too) and the class heads moved."""
    import os.path as osp

    from tpudenoise_torch.train import solver as solver_mod
    repo = default_config().ROOT_DIR
    inp = dict(repo=repo, root=osp.join(repo, 'build', 'chip_smoke_train'))
    inits = []

    def spy(make):
        def call(model, cfg, **kw):
            init, step = make(model, cfg, **kw)

            def init_state(*a):
                st = init(*a)
                inits.append((model, {k: v.clone()
                                      for k, v in st.params.items()}))
                return st
            return init_state, step
        return call

    with patched(solver_mod, 'make_train_step', spy):
        e, state, _, _, cfg, _ = train_cli(card, inp, 'mobile', TRAIN_NOISE,
                                           1, 'mobile')
    (model, before), = inits
    frozen = [n for n, _ in model.named_parameters() if model.frozen(n)]
    moved = [n for n, _ in model.named_parameters() if not model.frozen(n)
             and not torch.equal(state.params[n].cpu(), before[n].cpu())]
    kept = [n for n in frozen
            if torch.equal(state.params[n].cpu(), before[n].cpu())]
    if kept != frozen or not frozen:
        raise AssertionError(f'mobile step: frozen parameters changed: '
                             f'{sorted(set(frozen) - set(kept))[:5]}')
    for part in ('head.layer_5.', 'rpn.', 'tail.layer_13.pw_bn.', 'rcnn.'):
        if not any(n.startswith(part) for n in moved):
            raise AssertionError(f'mobile step: nothing in {part} moved')
    e.update(frozen=len(frozen), moved=len(moved))
    # the step's time: the solver of that run's config, 2 warm steps,
    # then TRAIN_TIMED by CUDA events (noise and the step)
    s, loader, st, _ = train_setup(cfg, torch.bfloat16, DEV, 'mobile_timed',
                                   net='mobile')
    key, evs = prng.PRNGKey(cfg.RNG_SEED), []
    for it in range(2 + TRAIN_TIMED):
        key, kn, ks = prng.split(key, 3)
        raw = loader.forward()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        st, _ = s._step_fn(st, ks, s._prep_batch(kn, raw))
        ev[1].record()
        if it >= 2:
            evs.append(ev)
    torch.cuda.synchronize()
    e['step_ms'] = statistics.median(a.elapsed_time(b) for a, b in evs)
    log(f'train mobile {TRAIN_NOISE}: {len(frozen)} frozen parameters '
        f'bit-equal after the step, {len(moved)} of the others moved; the '
        f'bf16 step at {s.bucket[0]}x{s.bucket[1]}, batch 1: median '
        f'{e["step_ms"]:.2f} ms of {TRAIN_TIMED} by CUDA events  [{card}]')
    return {f'train mobile {TRAIN_NOISE}': e}


def mobile_compute_id(card: str, inp: dict) -> dict:
    """cli.test --net mobile --compute-id over the CLI phase's 16 images,
    the seeded mobile of rrData's two classes with its BN randomized
    (mobile.yml, --eval-batch 8): kernel 1 once and kernel 3 and the
    walk twice a chunk, every launch held to its plain version; every
    logged TwoNN ID finite and positive."""
    import os.path as osp

    from tpudenoise_torch.analysis.twonn import PROBES
    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.convert import save_params_npz
    root = inp['root']
    npz = osp.join(root, 'mobile_probes.npz')
    save_params_npz(randomize_bn(seeded(FasterRCNN('mobile', num_classes=2)),
                                 17), npz)
    logged = {}

    class Tee:
        active_sinks = False

        def log(self, metrics, step=None):
            logged.update(metrics)

    argv = ['--net', 'mobile', '--compute-id', '--cfg', osp.join(
        inp['repo'], 'experiments', 'cfgs', 'mobile.yml'),
        '--imdb', 'rrData_2021_test', '--noise', LOOP_NOISE,
        '--eval-batch', str(B), '--model', npz,
        '--set', 'DATA_DIR', root, 'ROOT_DIR', root]
    with taped() as calls, patched(harness, 'get_metrics_logger',
                                   lambda fn: Tee):
        aps, wall, counts, _ = run_cli(cli_test.main, argv)
    held = hold_to_plain(calls, 'cli.test --net mobile --compute-id', card)
    del calls
    if len(aps) != 10 or not all(np.isfinite(a) for a in aps):
        raise AssertionError(f'cli.test --net mobile: APs {aps}')
    chunks = CLI_IMAGES // B
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    if launches != {'fused_sap_median_batched': chunks, MASKS: 2 * chunks,
                    WALK: 2 * chunks}:
        raise AssertionError(f'cli.test --net mobile: launches {launches}')
    ids = {p: logged.get(f'twonn_id/{p}') for p in PROBES['mobile']
           + ['head']}
    if not all(v is not None and np.isfinite(v) and v > 0
               for v in ids.values()):
        raise AssertionError(f'--net mobile --compute-id: IDs {ids}')
    log(f'cli.test --net mobile --compute-id over {CLI_IMAGES} images: '
        f'{wall:.2f} s; IDs ' + ', '.join(f'{k} {v:.2f}'
                                          for k, v in ids.items())
        + f'; launches {json.dumps(launches)}  [{card}]')
    return {'cli.test --net mobile --compute-id': dict(
        wall_s=wall, twonn_id=ids, launches=launches, held=held)}


def torchvision_resnet(num_layers: int, seed: int) -> dict:
    """A torchvision-layout resnet state dict of seeded random tensors
    (He-scaled convs, BN near the identity, the fc head), as a `.pth` of
    torchvision's holds them: nothing is fetched."""
    from tpudenoise_torch.models.convert import UNITS
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        std = np.sqrt(2.0 / (cin * k * k))
        sd[name] = torch.from_numpy(
            (rng.randn(cout, cin, k, k) * std).astype(np.float32))

    def bn(name, c):
        for leaf, lo, hi in (('weight', 0.5, 1.0), ('bias', -0.1, 0.1),
                             ('running_mean', -0.1, 0.1),
                             ('running_var', 0.5, 1.5)):
            sd[f'{name}.{leaf}'] = torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32))
        sd[f'{name}.num_batches_tracked'] = torch.tensor(0)

    conv('conv1.weight', 64, 3, 7)
    bn('bn1', 64)
    cin = 64
    for b, units in enumerate(UNITS[num_layers], start=1):
        w = 64 * 2 ** (b - 1)
        for u in range(units):
            base = f'layer{b}.{u}'
            conv(base + '.conv1.weight', w, cin, 1)
            bn(base + '.bn1', w)
            conv(base + '.conv2.weight', w, w, 3)
            bn(base + '.bn2', w)
            conv(base + '.conv3.weight', 4 * w, w, 1)
            bn(base + '.bn3', 4 * w)
            if u == 0:
                conv(base + '.downsample.0.weight', 4 * w, cin, 1)
                bn(base + '.downsample.1', 4 * w)
            cin = 4 * w
    sd['fc.weight'] = torch.from_numpy(
        (rng.randn(1000, cin) * 0.01).astype(np.float32))
    sd['fc.bias'] = torch.zeros(1000)
    return sd


def convert_cli(card: str, inp: dict) -> dict:
    """`cli.convert` on a torchvision-layout res101 `.pth` written here
    (`torchvision_resnet`), then `cli.test --net res101 --model` on the
    `.npz` over the CLI phase's images: it prints `Loaded n/N` with n the
    `.npz`'s entries, finite APs, every launch held to its plain
    version."""
    import io
    import os.path as osp

    from tpudenoise_torch.cli import convert as cli_convert
    from tpudenoise_torch.cli import test as cli_test
    root = inp['root']
    pth, npz = osp.join(root, 'resnet101.pth'), osp.join(root, 'tv101.npz')
    torch.save(torchvision_resnet(101, 19), pth)
    t0 = time.perf_counter()
    cli_convert.main(['--src', pth, '--net', 'res101', '--out', npz])
    t_convert = time.perf_counter() - t0
    with np.load(npz) as f:
        entries = len(f.files)
    argv = ['--net', 'res101', '--cfg', osp.join(
        inp['repo'], 'experiments', 'cfgs', 'res101.yml'),
        '--imdb', 'rrData_2021_test', '--noise', LOOP_NOISE,
        '--eval-batch', str(B), '--model', npz,
        '--set', 'DATA_DIR', root, 'ROOT_DIR', root]
    buf = io.StringIO()
    with taped() as calls, contextlib.redirect_stdout(buf):
        aps, wall, counts, _ = run_cli(cli_test.main, argv)
    printed = buf.getvalue()
    held = hold_to_plain(calls, 'cli.test --model (converted res101)', card)
    del calls
    n_params = len(FasterRCNN('res101', num_classes=2).state_dict())
    want = f'Loaded {entries}/{n_params} parameters'
    if want not in printed or 'WARNING' in printed:
        raise AssertionError(f'cli.test on the converted .npz: no "{want}"'
                             f' ({printed[-800:]})')
    if len(aps) != 10 or not all(np.isfinite(a) for a in aps):
        raise AssertionError(f'cli.test on the converted .npz: APs {aps}')
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    log(f'cli.convert res101 .pth -> {entries} entries in {t_convert:.2f} s;'
        f' cli.test --model on it printed "{want}", {wall:.2f} s; launches '
        f'{json.dumps(launches)}  [{card}]')
    return {'cli.convert + cli.test': dict(
        convert_s=t_convert, entries=entries, wall_s=wall,
        launches=launches, held=held)}


def automold_phase(card: str) -> dict:
    """augment_random with each name of AUG_TYPES forced, on AUTOMOLD_B
    seeded 600x1000 images on the card, one image a call, timed (ms per
    image, the card synchronized); each add_sun_flare launch of kernel 8
    held to its plain version; then AUTOMOLD_SMALL card against CPU for
    every name (tests/test_torch_automold.py's bounds)."""
    from tpudenoise_torch.noise import automold
    rng = np.random.RandomState(18)
    imgs = torch.from_numpy(rng.randint(0, 256, (AUTOMOLD_B, H, W, 3))
                            .astype(np.float32)).to(DEV)
    small = torch.from_numpy(rng.randint(0, 256, AUTOMOLD_SMALL).astype(
        np.float32))
    tapped = {'bloom_batched': (bl, 'bloom_batched', bloom_apply_scan)}
    ms, worst = {}, {}
    zero_counts()
    with taped(tapped) as calls:
        for name in automold.AUG_TYPES:
            walls = []
            for i, img in enumerate(imgs):
                key = prng.fold_in(prng.PRNGKey(18), i)
                out, t = _timed(automold.augment_random, key, img, [name])
                if out.shape != img.shape or not torch.isfinite(out).all():
                    raise AssertionError(f'automold {name}: {out.shape}')
                walls.append(t * 1e3)
            ms[name] = statistics.median(walls)
    launches = {'bloom_batched': launch_counts()['bloom_batched']}
    if launches['bloom_batched'] != AUTOMOLD_B:
        raise AssertionError(f'automold add_sun_flare: launches {launches}')
    held = hold_train_to_plain(calls, 'automold add_sun_flare', card)
    del calls
    for name in automold.AUG_TYPES:
        share = []
        for i, img in enumerate(small):
            key = prng.fold_in(prng.PRNGKey(19), i)
            got = automold.augment_random(key, img.to(DEV), [name]).cpu()
            want = automold.augment_random(key, img, [name])
            d = (got - want).abs()
            if ((d > 1).double().mean() > AUTOMOLD_FAR
                    or (d > 0).double().mean() > AUTOMOLD_NEAR):
                raise AssertionError(f'automold {name}: card and CPU differ '
                                     f'(max {d.max().item()})')
            share.append((d > 0).double().mean().item())
            worst[name] = max(worst.get(name, 0.0), d.max().item())
    log(f'automold on the card, ms per {H}x{W} image (median of '
        f'{AUTOMOLD_B}): ' + ', '.join(f'{k} {v:.2f}' for k, v in ms.items())
        + f'; card vs CPU at {AUTOMOLD_SMALL[1:3]} max |diff| '
        + ', '.join(f'{k} {v:g}' for k, v in worst.items())
        + f'; launches {json.dumps(launches)}  [{card}]')
    return {'automold': dict(ms_per_image=ms, small_max_abs_err=worst,
                             launches=launches, held=held)}


def slice16_phase(card: str, mob, cli: dict) -> dict:
    """Phase 5f: the mobile chunks, the mobile training step, `cli.test
    --net mobile --compute-id`, `cli.convert`'s torchvision path and the
    Automold suite."""
    out = mobile_paths(card, mob)
    out.update(mobile_train(card))
    out.update(mobile_compute_id(card, cli))
    out.update(convert_cli(card, cli))
    out.update(automold_phase(card))
    return out


# ------------------------------------------------ slice 18: phase 5h --

# the converted checkpoints' images: a VOC set (the detector's 21 classes)
# of the CLI phase's count and size
CONVERT_IMAGES = 16
CONVERT_ITERS = 2
# the XLA route's strings (make_pipeline(..., use_kernels=False)), each
# with fast_rng off and on, and the CPU bound of each against the card
# on the card's draws: bit-exact (uniform draws, integer stencils) or a
# mod-256 distance <= 1 on <= 1e-3 of the elements (the card's and the
# CPU's log, exp and cos; tests/test_torch_backend_xla's bound)
XLA_NOISES = ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
              'noise_mix_var_all', 'noise_mix_var_all_bilateral')
XLA_EXACT = {'sap_median_var0.4'}
XLA_SHARE = 1e-3
# the XLA route's wrappers: the training path's, its bilateral stages
# through the stencils module's
XLA_TAPPED = {**TRAIN_TAPPED,
              'bilateral_batched': (stencils, 'bilateral_batched',
                                    bil.bilateral_plain)}


def slim_resnet_arrays(tree: dict, net: str, detector: bool) -> dict:
    """{checkpoint name: array} of a JAX-layout resnet tree under the
    reference's slim scopes (the converters' mapping run backwards): the
    backbone, and with detector the rpn and cls/bbox heads and a
    global_step."""
    from tpudenoise_torch.models.convert import DETECTOR_SCOPES
    scope = DETECTOR_SCOPES[net]
    out = {}

    def bn(prefix, p):
        for leaf, name in (('gamma', 'gamma'), ('beta', 'beta'),
                           ('mean', 'moving_mean'),
                           ('var', 'moving_variance')):
            out[f'{prefix}/BatchNorm/{name}'] = p[leaf]

    head = tree['head']
    out[f'{scope}/conv1/weights'] = head['conv1']['kernel']
    bn(f'{scope}/conv1', head['conv1_bn'])
    blocks = {**{k: v for k, v in head.items() if k.startswith('block')},
              **tree['tail']['tail']}
    for b, block in blocks.items():
        for u, unit in block.items():
            base = f'{scope}/{b}/{u}/bottleneck_v1'
            for name, p in unit.items():
                if 'bn' in name:      # bn1..3 -> convN, shortcut_bn
                    bn(f'{base}/' + ('shortcut' if name == 'shortcut_bn'
                                     else f'conv{name[2]}'), p)
                else:
                    out[f'{base}/{name}/weights'] = p['kernel']
    if detector:
        heads = {**tree['rpn'], **tree['tail']['rcnn']}
        for name, p in heads.items():
            ckpt = 'rpn_conv/3x3' if name == 'rpn_conv' else name
            out[f'{scope}/{ckpt}/weights'] = p['kernel']
            out[f'{scope}/{ckpt}/biases'] = p['bias']
        out['global_step'] = np.int64(70000)
    return out


def _same_leaves(got: dict, want: dict, what: str) -> int:
    """Two JAX-layout trees, leaf for leaf and bit for bit."""
    from tpudenoise_torch.models.convert import _flatten
    got, want = _flatten(got), _flatten(want)
    if sorted(got) != sorted(want):
        odd = sorted(set(got) ^ set(want))[:5]
        raise AssertionError(f'{what}: leaves {odd} differ')
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g, w):
            raise AssertionError(f'{what}: {k} differs from the written '
                                 f'array')
    return len(want)


def convert_sources(card: str, root: str) -> dict:
    """The port's writer writes a seeded full-width resnet_v1_101 (slim
    ImageNet scopes) and a res101 detector (the reference's scopes, 21
    classes, global_step) as V2 checkpoints; `cli.convert` turns each
    into a `.npz` (host seconds and MB/s of the data file logged), whose
    tree must equal the written arrays bit for bit, conv1 flipped to BGR
    in the ImageNet one only."""
    import os.path as osp

    from tpudenoise_torch.cli import convert as cli_convert
    from tpudenoise_torch.models.convert import (_unflatten, save_tree_npz,
                                                 to_jax_flat)
    from tpudenoise_torch.models.tf_checkpoint import write_checkpoint
    out, info = {}, {}
    for kind, classes, seed in (('imagenet', 2, 23), ('detector', 21, 24)):
        tree = _unflatten(to_jax_flat(randomized_resnet('res101', seed,
                                                        classes)))
        if kind == 'imagenet':
            tree = {'head': tree['head'],
                    'tail': {'tail': tree['tail']['tail']}}
        prefix = osp.join(root, f'res101_{kind}.ckpt')
        t0 = time.perf_counter()
        write_checkpoint(prefix, slim_resnet_arrays(tree, 'res101',
                                                    kind == 'detector'))
        t_write = time.perf_counter() - t0
        mb = osp.getsize(prefix + '.data-00000-of-00001') / 1e6
        npz = osp.join(root, f'res101_{kind}.npz')
        argv = ['--src', prefix, '--net', 'res101', '--out', npz]
        t0 = time.perf_counter()
        got = cli_convert.main(argv + (['--detector'] if kind == 'detector'
                                       else []))
        t_convert = time.perf_counter() - t0
        want = copy.deepcopy(tree)
        if kind == 'imagenet':
            conv1 = want['head']['conv1']
            conv1['kernel'] = conv1['kernel'][:, :, ::-1, :]
        leaves = _same_leaves(got, want, f'cli.convert {kind}')
        with np.load(npz) as f:
            entries = len(f.files)
        if entries != leaves:
            raise AssertionError(f'cli.convert {kind}: {entries} entries')
        info[kind] = dict(prefix=prefix, npz=npz, entries=entries)
        if kind == 'detector':
            info[kind]['straight'] = osp.join(root, 'res101_straight.npz')
            save_tree_npz(tree, info[kind]['straight'])
        out[f'cli.convert res101 {kind}'] = dict(
            data_mb=mb, write_s=t_write, convert_s=t_convert,
            mb_per_s=mb / t_convert, entries=entries, launches={})
        log(f'cli.convert res101 {kind}: V2 checkpoint of {mb:.1f} MB '
            f'(written by the port in {t_write:.2f} s) -> {entries} '
            f'entries in {t_convert:.2f} s of host time ({mb / t_convert:.1f}'
            f' MB/s, every block and tensor crc32c checked); the tree equals'
            f' the written arrays bit for bit'
            + (', conv1 flipped to BGR' if kind == 'imagenet' else '')
            + f'  [{card}]')
    return out, info


def convert_train(card: str, npz: str, entries: int) -> dict:
    """cli.trainval --weight on the converted ImageNet `.npz`,
    CONVERT_ITERS iterations on the training phase's images: `Loaded
    n/N` with n the file's entries, finite losses, every launch held to
    its plain version."""
    import io
    import os.path as osp
    repo = default_config().ROOT_DIR
    inp = dict(repo=repo, root=osp.join(repo, 'build', 'chip_smoke_train'))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry = train_cli(card, inp, 'res101', TRAIN_NOISE, CONVERT_ITERS,
                          'converted', extra=('--weight', npz))[0]
    printed = buf.getvalue()
    print(printed[-4000:], end='', flush=True)
    want = f'Loaded {entries}/'
    if want not in printed or 'matched no model parameter' in printed:
        raise AssertionError(f'cli.trainval --weight: no "{want}" '
                             f'({printed[-800:]})')
    if len(entry['iterations']) != CONVERT_ITERS:
        raise AssertionError(f'cli.trainval --weight: iterations '
                             f'{entry["iterations"]}')
    return {'cli.trainval --weight (converted res101)': entry}


def convert_eval(card: str, root: str, det: dict) -> dict:
    """cli.test --model with the converted detector over CONVERT_IMAGES
    numpy-written VOC images of 600x1000, LOOP_NOISE, --eval-batch 8:
    20 finite APs, kernel 1 once and kernel 3 and the walk twice a chunk,
    every launch held to its plain version; then the same command with
    the `.npz` that save_tree_npz wrote from the same arrays: the same
    detections, bit for bit."""
    import os.path as osp
    import pickle

    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    cfg = default_config()
    cfg.ROOT_DIR = root
    synthetic.write_voc(root, [(H, W)] * CONVERT_IMAGES, seed=13,
                        pixel_dir=default_pixel_dir('voc_2007_test', cfg))
    chunks = CONVERT_IMAGES // B
    dets, out = {}, {}
    for which in ('npz', 'straight'):
        npz = det[which]
        argv = ['--net', 'res101', '--cfg', osp.join(
            default_config().ROOT_DIR, 'experiments', 'cfgs', 'res101.yml'),
            '--imdb', 'voc_2007_test', '--noise', LOOP_NOISE,
            '--eval-batch', str(B), '--model', npz,
            '--set', 'DATA_DIR', root, 'ROOT_DIR', root]
        with taped() as calls:
            aps, wall, counts, run_cfg = run_cli(cli_test.main, argv)
        if len(aps) != 20 or not all(np.isfinite(a) for a in aps):
            raise AssertionError(f'cli.test --model {which}: APs {aps}')
        launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                    + NMS_KERNELS}
        if launches != {'fused_sap_median_batched': chunks,
                        MASKS: 2 * chunks, WALK: 2 * chunks}:
            raise AssertionError(f'cli.test --model {which}: launches '
                                 f'{launches}')
        path = f'cli.test --model ({which} res101 detector)'
        held = hold_to_plain(calls, path, card)
        del calls
        imdb_name = 'voc_2007_test'
        with open(osp.join(get_output_dir(imdb_name, npz.replace('/', '_'),
                                          run_cfg), 'detections.pkl'),
                  'rb') as f:
            dets[which] = pickle.load(f)
        n = sum(len(np.asarray(d).reshape(-1, 5)) for c in dets[which][1:]
                for d in c)
        log(f'{path} over {CONVERT_IMAGES} VOC images of {H}x{W}, '
            f'{LOOP_NOISE}, --eval-batch {B}: main() {wall:.2f} s, mAP '
            f'{np.mean(aps):.4f}, {n} detections; launches '
            f'{json.dumps(launches)}  [{card}]')
        if which == 'npz':
            out[path] = dict(wall_s=wall, aps=aps, detections=n,
                             launches=launches, held=held)
    for c, (a, b) in enumerate(zip(dets['npz'], dets['straight'])):
        for i, (x, y) in enumerate(zip(a, b)):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f'cli.test: class {c} image {i}: the '
                                     f'converted detector detects otherwise '
                                     f'than the same arrays saved directly')
    log(f'cli.test --model: the converted detector\'s detections equal '
        f'those of the directly saved arrays, bit for bit  [{card}]')
    return out


def _xla_route_launches(counts: dict, noise: str, fast: bool) -> dict:
    """The XLA route's chunk: its draws (the hash kernel's under fast),
    kernel 5 for the bilateral post-pass, kernel 3 and the walk twice, no
    fused kernel."""
    draw = 'hash_draw' if fast else 'threefry_draw'
    want = [draw] + (['bilateral_batched'] if noise.endswith('_bilateral')
                     else [])
    fused = ('fused_sap_median_batched', 'fused_gaussian_blur',
             'fused_mix_noise', 'fused_mix_bilateral')
    launches = {k: counts[k] for k in want + list(NMS_KERNELS)
                + ['threefry_draw']}
    if (not all(counts[k] for k in want) or any(counts[k] for k in fused)
            or any(counts[k] != 2 for k in NMS_KERNELS)):
        raise AssertionError(f'{noise} use_kernels=False: launches {counts}')
    return launches


# the draw wrappers whose card outputs the CPU reference replays
DRAWS = ('threefry_draw', 'hash_draw')


@contextlib.contextmanager
def replayed(calls: dict):
    """prng's draw wrappers return the recorded card draws, in order, on
    the host (each call's arguments checked against the recorded ones):
    the CPU then computes from the card's own draws, which are held to
    their plain version apart."""
    queues = {name: list(calls.get(name, [])) for name in DRAWS}

    def replay(name):
        def call(*a, **k):
            ra, rk, out = queues[name].pop(0)
            if not (torch.equal(a[0], ra[0].cpu()) and a[1:] == tuple(ra[1:])
                    and k == rk):
                raise AssertionError(f'{name}: the CPU drew otherwise than '
                                     f'the card')
            return out.cpu()
        return lambda fn: call

    with patched(prng, 'threefry_draw', replay('threefry_draw')), \
            patched(prng, 'hash_draw', replay('hash_draw')):
        yield
    left = {k: len(v) for k, v in queues.items() if v}
    if left:
        raise AssertionError(f'draws the CPU did not make: {left}')


def xla_route(card: str, res) -> dict:
    """make_pipeline(..., use_kernels=False) (the reference's XLA route)
    on one res101 chunk of 8 for XLA_NOISES, fast_rng off and on:
    detect_chunk's detections finite, the route's launches, every launch
    held to its plain version (the draws: threefry normals within 2 ulp,
    the rest bit-exact); its noise output (the keyed noise of the chunk's
    keys) held to the same route on the CPU fed the card's draws
    (`replayed`: a Brownian path sums 1.8M increments, so a draw's last
    ulp moves its wrapped bytes anywhere), XLA_EXACT bit-exact and the
    others within a mod-256 distance of 1 on <= XLA_SHARE of the elements
    (the CPU's and the card's log, exp and cos); the noise stage's ms by
    CUDA events beside the default (kernel) route's on the same keys."""
    model, params, raw, levels, key = res
    idx = list(range(B))
    keys = prng.fold_in(key, np.asarray(idx))
    raw_cpu = raw.cpu()
    out = {}
    for fast in (False, True):
        for noise in XLA_NOISES:
            fn = make_pipeline(noise, use_kernels=False, fast_rng=fast)
            kfn = make_pipeline(noise, fast_rng=fast)
            name = f'res101 {noise} use_kernels=False' + (
                ' --fast-rng' if fast else '')
            zero_counts()
            with taped(XLA_TAPPED) as calls:
                boxes, scores, mask = detect_chunk(model, params, key, idx,
                                                   raw, levels, fn)
                torch.cuda.synchronize()
            launches = _xla_route_launches(launch_counts(), noise, fast)
            sc, kept = scores.cpu().numpy(), mask.cpu().numpy()
            if not (np.isfinite(boxes.cpu().numpy()).all()
                    and np.isfinite(sc[kept]).all() and kept.any()):
                raise AssertionError(f'{name}: detections not finite or '
                                     f'none kept')
            held = hold_train_to_plain(calls, name, card)
            del calls
            with taped({k: TRAIN_TAPPED[k] for k in DRAWS}) as draws:
                got = fn.keyed(keys, raw).cpu()
            with replayed(draws):
                want = fn.keyed(keys, raw_cpu)
            del draws
            d = (got.double() - want.double()).abs()
            d = torch.minimum(d, 256.0 - d)
            err, share = d.max().item(), (d > 0).double().mean().item()
            if (err if noise in XLA_EXACT else
                    (err > 1 or share > XLA_SHARE)):
                raise AssertionError(f'{name}: card and CPU differ (max '
                                     f'{err}, share {share:.2e})')
            ms = time_ms(lambda: fn.keyed(keys, raw), 3, warm=1)
            kms = time_ms(lambda: kfn.keyed(keys, raw), 3, warm=1)
            out[name] = dict(backend=fn.backend, noise_ms=ms,
                             kernel_route=kfn.backend, kernel_noise_ms=kms,
                             max_abs_err=err, changed_share=share,
                             launches=launches, held=held)
            log(f'{name}: backend {fn.backend}, noise stage {ms:.2f} ms a '
                f'chunk of {B} by CUDA events ({kfn.backend}: {kms:.2f} '
                f'ms); card vs CPU on the card\'s draws: max mod-256 |diff| '
                f'{err:g} on {share:.2e} of the elements; launches '
                f'{json.dumps(launches)}  [{card}]')
    return out


def slice18_phase(card: str, res) -> dict:
    """Phase 5h: the TensorFlow sources of cli.convert through the port's
    checkpoint reader (ImageNet and detector res101 at full width), the
    converted weights through cli.trainval --weight and cli.test --model,
    and the XLA route (use_kernels=False) on res101 chunks."""
    import os.path as osp
    import shutil
    root = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_convert')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, info = convert_sources(card, root)
    out.update(convert_train(card, info['imagenet']['npz'],
                             info['imagenet']['entries']))
    out.update(convert_eval(card, root, info['detector']))
    out.update(xla_route(card, res))
    return out


# ------------------------------------------------ slice 19: phase 5i --

# phase 5i: the iterations of the rpn-roidb training, the phase's budget
# in seconds (logged against), the test driver's arguments and where the
# drivers live
RPN_ITERS = 2
PHASE_5I_S = 30.0
TEST_DRIVER_ARGS = ('0', 'rrData', 'res101', LOOP_NOISE)
SCRIPTS_DIR = os.path.join('tpudenoise_torch', 'experiments', 'scripts')
# the subprocesses' time limit
SCRIPT_TIMEOUT = 300


def _script(repo: str, work: str, name: str, args, log_name: str):
    """Start `bash tpudenoise_torch/experiments/scripts/<name> args` in
    work, its output to work/<log_name>, the repo on PYTHONPATH and this
    interpreter's directory first on PATH (the drivers call `python`)."""
    import subprocess
    env = {**os.environ, 'PYTHONPATH': repo,
           'PATH': os.path.dirname(sys.executable) + os.pathsep
           + os.environ.get('PATH', '')}
    out = open(os.path.join(work, log_name), 'w')
    proc = subprocess.Popen(['bash', os.path.join(repo, SCRIPTS_DIR, name),
                             *args], cwd=work, env=env, stdout=out,
                            stderr=subprocess.STDOUT)
    return proc, out


def _finish(proc, out, what: str) -> str:
    """Wait for a started script; its output, or an AssertionError with
    its tail when it failed."""
    try:
        rc = proc.wait(timeout=SCRIPT_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    with open(out.name) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f'{what} exited {rc}:\n{text[-3000:]}')
    return text


def proposals_5i(card: str, loop: dict) -> tuple:
    """The seeded res101's proposals on the dataset phase's LOOP_IMAGES
    images: forward_test in chunks of 8 (bf16, bucket 608x1024, scale 1),
    each image's valid rois rescaled to image coordinates; kernel 3 and
    the walk once a chunk, held to their plain versions.  Returns the
    proposal list and the e2e entry."""
    from tpudenoise_torch.ops.resize import prep_on_device
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = loop['root']
    imdb = rrData('test', config=cfg, pixel_dir=loop['pixel_dir'])
    model = FasterRCNN('res101', num_classes=imdb.num_classes,
                       cfg=default_config())
    params = seeded(model)
    model.to(DEV)
    params = {k: v.to(DEV) for k, v in params.items()}
    geom = torch.tensor([[H, W, H, W, 1.0]] * B, device=DEV)
    proposals = []
    zero_counts()
    with taped() as calls:
        t0 = time.perf_counter()
        for c in range(0, imdb.num_images, B):
            raw = torch.from_numpy(np.stack([
                read_bgr(imdb.image_path_at(i)) for i in range(c, c + B)])
            ).to(DEV)
            imgs = prep_on_device(raw.float(), geom, model.cfg.PIXEL_MEANS,
                                  BUCKET)
            out = model.forward_test(params, imgs, geom[:, 2:])
            rois = out['rois'] / geom[:, 4, None, None]
            for j in range(B):
                proposals.append(rois[j][out['roi_mask'][j]].cpu().numpy()
                                 .astype(np.float32))
        wall = time.perf_counter() - t0
    counts = launch_counts()
    chunks = imdb.num_images // B
    launches = {k: counts[k] for k in NMS_KERNELS}
    if launches != {MASKS: chunks, WALK: chunks}:
        raise AssertionError(f'proposals: launches {launches}')
    held = hold_to_plain(calls, 'rpn proposals (res101 forward_test)', card)
    del calls, model, params
    n = [len(p) for p in proposals]
    if min(n) == 0 or not all(np.isfinite(p).all() for p in proposals):
        raise AssertionError(f'proposals: {n} boxes an image')
    log(f'rpn proposals: seeded res101 forward_test over {imdb.num_images} '
        f'images of {H}x{W} in {wall:.2f} s, {min(n)}-{max(n)} boxes an '
        f'image; launches {json.dumps(launches)}  [{card}]')
    return proposals, dict(wall_s=wall, boxes=[min(n), max(n)],
                           launches=launches, held=held)


def recall_5i(card: str, loop: dict, proposals) -> dict:
    """evaluate_recall of the proposals on the card and on the CPU: the
    same ar, recalls and matched overlaps."""
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = loop['root']
    imdb = rrData('test', config=cfg, pixel_dir=loop['pixel_dir'])
    res = {}
    for dev in (DEV, 'cpu'):
        imdb.device = dev
        _ = imdb.roidb
        res[dev], t = _timed(imdb.evaluate_recall, proposals)
        res[dev]['s'] = t
    a, b = res[DEV], res['cpu']
    if not (a['ar'] == b['ar'] and np.array_equal(a['recalls'], b['recalls'])
            and np.array_equal(a['gt_overlaps'], b['gt_overlaps'])
            and np.isfinite(a['ar'])):
        raise AssertionError(f'evaluate_recall: card {a} against CPU {b}')
    log(f'evaluate_recall over {imdb.num_images} images: AR {a["ar"]:.4f}, '
        f'recall@0.5 {a["recalls"][0]:.4f}, the gt boxes\' best IoU '
        f'{a["gt_overlaps"].min():.4f}-{a["gt_overlaps"].max():.4f}, card '
        f'{a["s"]:.3f} s, CPU '
        f'{b["s"]:.3f} s; card and CPU equal  [{card}]')
    return dict(ar=float(a['ar']), recalls=a['recalls'].tolist(),
                card_s=a['s'], cpu_s=b['s'], launches={})


def rpn_training_5i(card: str, loop: dict, rpn_file: str) -> dict:
    """The rpn proposal method through training: rrData trainval over the
    dataset phase's images (the test list copied) with its proposals,
    `get_training_roidb` (flips) and `filter_roidb` built with the IoU on
    the card and on the CPU (the same rows and the same images kept),
    then `train_net` RPN_ITERS iterations on the card: finite losses, the
    batches' boxes the gt rows only, every launch held to its plain
    version."""
    import os.path as osp
    import shutil

    from tpudenoise_torch.core.config import cfg_from_file
    from tpudenoise_torch.data.roidb import filter_roidb, get_training_roidb
    from tpudenoise_torch.train.solver import train_net
    root = loop['root']
    sets = osp.join(root, '6thfloorData', '6thFloorTest', 'Annotations_cvat',
                    '6thFloorTest', 'ImageSets', 'Main')
    shutil.copy(osp.join(sets, 'test.txt'), osp.join(sets, 'trainval.txt'))
    cfg = cfg_from_file(osp.join(default_config().ROOT_DIR, 'experiments',
                                 'cfgs', 'res101.yml'),
                        into=default_config())
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    cfg.TRAIN.DISPLAY = 1
    built = {}
    for dev in (DEV, 'cpu'):
        imdb = rrData('trainval', config=cfg, pixel_dir=loop['pixel_dir'])
        imdb.device = dev
        imdb.config['rpn_file'] = rpn_file
        imdb.set_proposal_method('rpn')
        (roidb, t) = _timed(get_training_roidb, imdb, TRAIN_NOISE, cfg)
        built[dev] = (imdb, roidb, filter_roidb(roidb, cfg), t)
    (imdb, roidb, kept, t_card), (_, roidb_cpu, kept_cpu, t_cpu) = (
        built[DEV], built['cpu'])
    for a, b in zip(roidb, roidb_cpu):
        for k in ('boxes', 'gt_classes', 'gt_overlaps', 'max_overlaps'):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f'rpn roidb: {k} differs card and CPU')
    images = [(e['image'], e['flipped']) for e in kept]
    if (len(roidb) != len(roidb_cpu)
            or images != [(e['image'], e['flipped']) for e in kept_cpu]):
        raise AssertionError('filter_roidb keeps other images card and CPU')
    rows = sum(len(e['boxes']) for e in roidb)
    gt_rows = sum(int((e['gt_classes'] != 0).sum()) for e in roidb)
    model = FasterRCNN('res101', num_classes=imdb.num_classes, cfg=cfg)
    out_dir = osp.join(root, 'output_rpn')
    path = f'train res101 {TRAIN_NOISE} rpn roidb --iters {RPN_ITERS}'
    zero_counts()
    with taped(TRAIN_TAPPED) as calls, recording() as (seen, _):
        _, wall = _timed(lambda: train_net(
            model, imdb, kept, list(kept), out_dir, osp.join(root, 'tb_rpn'),
            max_iters=RPN_ITERS, noise=TRAIN_NOISE, config=cfg,
            bucket=BUCKET, device=DEV))
    launches = check_train_launches(launch_counts(), 'res101', TRAIN_NOISE,
                                    len(seen), path)
    held = hold_train_to_plain(calls, path, card)
    del calls
    losses = [x['losses'] for x in seen]
    if len(seen) != RPN_ITERS or not all(
            np.isfinite(v) for x in losses for v in x.values()):
        raise AssertionError(f'{path}: losses {losses}')
    # the fixture draws 1-3 boxes an image: a batch holds those and none
    # of the image's hundreds of proposal rows
    for x in seen:
        n_gt = int(x['batch']['gt_mask'].sum())
        if not 1 <= n_gt <= 3:
            raise AssertionError(f'{path}: {n_gt} gt boxes in a batch')
    log(f'rpn roidb: {len(roidb)} entries (flips), {rows} rows of which '
        f'{gt_rows} gt, built in {t_card:.3f} s with the IoU on the card '
        f'({t_cpu:.3f} s on the CPU, the same rows); filter_roidb keeps '
        f'{len(kept)}, the same images card and CPU; {path}: '
        f'{wall:.2f} s, total_loss '
        + ', '.join(f'{x["total_loss"]:.4f}' for x in losses)
        + f'; launches {json.dumps(launches)}  [{card}]')
    return dict(entries=len(roidb), kept=len(kept), rows=rows,
                gt_rows=gt_rows, roidb_card_s=t_card, roidb_cpu_s=t_cpu,
                wall_s=wall, losses=losses, launches=launches, held=held)


def _same_dets(a, b, what: str, ordered: bool = True) -> int:
    """all_boxes a and b equal bit for bit (unordered: each image's rows
    as a set); returns the detections of the classes past background."""
    if len(a) != len(b):
        raise AssertionError(f'{what}: {len(a)} against {len(b)} classes')
    n = 0
    for c, (x, y) in enumerate(zip(a, b)):
        for i, (p, q) in enumerate(zip(x, y)):
            p, q = (np.asarray(v).reshape(-1, 5) for v in (p, q))
            if not ordered:
                p, q = (v[np.lexsort(v.T[::-1])] for v in (p, q))
            if p.shape != q.shape or not np.array_equal(p, q):
                raise AssertionError(f'{what}: class {c} image {i} differs')
            n += len(p) if c else 0
    return n


def reval_5i(card: str, cli: dict, out_dir: str) -> dict:
    """cli.reval --nms on the detections in out_dir: on the card (kernel 3
    and the walk, held to their plain versions), and on the CPU with
    USE_NATIVE_NMS set (the host C++ NMS) and unset (nms_py); the kept
    boxes equal in all three.  Then apply_nms_all's time on each route
    (host clock, the card synchronized)."""
    import pickle

    import tpudenoise_torch.core.config as config
    from tpudenoise_torch.cli import reval
    with open(os.path.join(out_dir, 'detections.pkl'), 'rb') as f:
        all_boxes = pickle.load(f)
    kept, aps, out = {}, {}, {}

    def recorder(name):
        def wrap(fn):
            def call(*a, **k):
                kept[name] = fn(*a, **k)
                return kept[name]
            return call
        return wrap

    routes = (('cuda', DEV, True), ('cpu native', 'cpu', True),
              ('cpu nms_py', 'cpu', False))
    for name, dev, native_ in routes:
        def main_(argv, native_=native_):
            config.cfg.DATA_DIR = config.cfg.ROOT_DIR = cli['root']
            config.cfg.USE_NATIVE_NMS = native_
            return reval.main(argv)
        with taped() as calls, patched(reval, 'apply_nms_all',
                                       recorder(name)):
            aps[name], wall, counts, _ = run_cli(main_, [
                out_dir, '--imdb', 'rrData_2021_test', '--nms', '--device',
                dev])
        n_launch = {k: counts[k] for k in NMS_KERNELS}
        if (dev == 'cpu') == any(n_launch.values()):
            raise AssertionError(f'reval --nms {name}: launches {n_launch}')
        held = hold_to_plain(calls, f'cli.reval --nms ({name})', card) \
            if dev != 'cpu' else {}
        del calls
        out[name] = dict(wall_s=wall, aps=aps[name], launches=n_launch,
                         held=held)
    # the card and the host C++ NMS take tied scores in input order, so
    # their rows agree in order too; nms_py takes ties in the order its
    # argsort leaves, so its kept rows are compared as a set, and its APs
    # (voc_eval sorts ties by input order) only for being finite
    n = _same_dets(kept['cuda'], kept['cpu native'], 'reval --nms card '
                   'against the host C++ NMS')
    _same_dets(kept['cuda'], kept['cpu nms_py'], 'reval --nms card against '
               'nms_py', ordered=False)
    if aps['cuda'] != aps['cpu native'] or not all(
            np.isfinite(a) for a in aps['cpu nms_py']):
        raise AssertionError(f'reval --nms APs {aps}')
    from tpudenoise_torch.ops.native import nms_host
    from tpudenoise_torch.ops.nms import nms_dets, nms_py
    fns = {'cuda': lambda d, t: nms_dets(d, t, DEV),
           'cpu native': nms_host, 'cpu nms_py': nms_py}
    thresh = default_config().TEST.NMS
    dets = [np.asarray(d) for per in all_boxes for d in per
            if np.asarray(d).size]
    calls_n, times = len(dets), {}
    for name, fn in fns.items():
        per = []
        for _ in range(3):
            t0 = time.perf_counter()
            for d in dets:
                fn(d, thresh)
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
        times[name] = min(per) * 1e3
    log(f'cli.reval --nms over {calls_n} (class, image) NMS calls: the '
        f'same {n} kept boxes on the card, the host C++ NMS and nms_py '
        f'(order and APs equal card and C++); '
        f'AP@.5 {aps["cuda"][0]:.4f}; NMS time (host clock, best of 3): '
        + ', '.join(f'{k} {v:.2f} ms' for k, v in times.items())
        + f'  [{card}]')
    return {f'cli.reval --nms ({k})': dict(v, nms_ms=times[k],
                                            nms_calls=calls_n)
            for k, v in out.items()}


def start_drivers(cli: dict, snapshot: str, work: str) -> dict:
    """Start test_faster_rcnn.sh and train_faster_rcnn.sh in work (a
    scratch working directory) on the snapshot placed where both look
    (the train driver then takes its NET_FINAL skip), with a copy of
    experiments/cfgs/res101.yml that points DATA_DIR and ROOT_DIR at the
    CLI phase's dataset.  Returns the started processes."""
    import os.path as osp
    repo = default_config().ROOT_DIR
    cfgs = osp.join(work, 'experiments', 'cfgs')
    os.makedirs(cfgs)
    with open(osp.join(repo, 'experiments', 'cfgs', 'res101.yml')) as f:
        text = f.read()
    with open(osp.join(cfgs, 'res101.yml'), 'w') as f:
        f.write(text + f'DATA_DIR: "{cli["root"]}"\n'
                       f'ROOT_DIR: "{cli["root"]}"\n')
    final = osp.join(work, 'output', 'res101', 'rrData_2021_train',
                     'default', 'res101_faster_rcnn_iter_5000')
    os.makedirs(osp.dirname(final))
    for ext in ('.pt', '.pkl'):
        os.symlink(snapshot + ext, final + ext)
    return {'test': _script(repo, work, 'test_faster_rcnn.sh',
                            TEST_DRIVER_ARGS, 'test_driver.log'),
            'train': _script(repo, work, 'train_faster_rcnn.sh',
                             TEST_DRIVER_ARGS, 'train_driver.log')}


def start_convert(work: str, src: str) -> dict:
    """Start convert_vgg16.sh on src in work."""
    return {'convert': _script(default_config().ROOT_DIR, work,
                               'convert_vgg16.sh', (src, 'vgg16_script.npz'),
                               'convert_driver.log')}


def test_driver_5i(card: str, cli: dict, work: str, started: dict,
                   t_start: float) -> tuple:
    """test_faster_rcnn.sh's detections against a direct cli.test call with
    the same arguments from the same directory (taped, every launch held
    to its plain version): equal bit for bit.  Returns the e2e entry and
    the output directory."""
    import os.path as osp
    import pickle

    from tpudenoise_torch.cli import test as cli_test
    text = _finish(*started['test'], 'test_faster_rcnn.sh')
    script_s = time.perf_counter() - t_start
    if 'Restored the params of snapshot' not in text:
        raise AssertionError(f'test_faster_rcnn.sh did not test the '
                             f'snapshot:\n{text[-2000:]}')
    cfg = default_config()
    cfg.ROOT_DIR = cli['root']
    cfg.EXP_DIR = 'res101'
    out_dir = get_output_dir('rrData_2021_test', 'default', cfg)
    with open(osp.join(out_dir, 'detections.pkl'), 'rb') as f:
        script_dets = pickle.load(f)
    argv = ['--model', osp.join('output', 'res101', 'rrData_2021_train',
                                'default', 'res101_faster_rcnn_iter_5000'),
            '--imdb', 'rrData_2021_test', '--cfg',
            osp.join('experiments', 'cfgs', 'res101.yml'), '--net',
            'res101', '--tag', 'default', '--noise', LOOP_NOISE, '--set',
            'ANCHOR_SCALES', '[8,16,32]', 'ANCHOR_RATIOS', '[0.5,1,2]']
    with contextlib.chdir(work), taped() as calls:
        aps, wall, counts, _ = run_cli(cli_test.main, argv)
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    n_img = CLI_IMAGES
    if launches != {'fused_sap_median_batched': n_img, MASKS: 2 * n_img,
                    WALK: 2 * n_img}:
        raise AssertionError(f'cli.test (direct): launches {launches}')
    held = hold_to_plain(calls, 'cli.test (the test driver\'s arguments)',
                         card)
    del calls
    with open(osp.join(out_dir, 'detections.pkl'), 'rb') as f:
        direct = pickle.load(f)
    n = _same_dets(script_dets, direct, 'test_faster_rcnn.sh against the '
                   'direct cli.test')
    if len(aps) != 10 or not all(np.isfinite(a) for a in aps):
        raise AssertionError(f'cli.test (direct): APs {aps}')
    log(f'test_faster_rcnn.sh {" ".join(TEST_DRIVER_ARGS)} on the '
        f'{CONVERT_ITERS}-iteration snapshot (at ..._iter_5000), '
        f'{n_img} images of {H}x{W}: done {script_s:.2f} s after its start '
        f'(a process of its own); its {n} detections equal the direct '
        f'cli.test\'s bit for bit (main() {wall:.2f} s, '
        f'{n_img / wall:.1f} img/s); launches {json.dumps(launches)}  '
        f'[{card}]')
    return dict(script_s=script_s, wall_s=wall, img_per_s=n_img / wall,
                aps=aps, detections=n, launches=launches, held=held), out_dir


def direct_convert_5i(work: str, src: str) -> float:
    """cli.convert called directly, in process, on the convert driver's
    source (while the drivers run); returns its wall seconds."""
    import io
    import os.path as osp

    from tpudenoise_torch.cli import convert as cli_convert
    with contextlib.redirect_stdout(io.StringIO()):
        _, wall = _timed(cli_convert.main, [
            '--src', src, '--net', 'vgg16', '--out',
            osp.join(work, 'vgg16_direct.npz')])
    return wall


def convert_driver_5i(card: str, work: str, started: dict, t_start: float,
                      source_mb: float, direct_s: float) -> dict:
    """convert_vgg16.sh's .npz against the direct cli.convert's, array for
    array bit-equal; the train driver took its NET_FINAL skip (no
    trainval call)."""
    import os.path as osp
    text = _finish(*started['train'], 'train_faster_rcnn.sh')
    if 'tpudenoise_torch.cli.trainval' in text:
        raise AssertionError('train_faster_rcnn.sh trained though its '
                             'NET_FINAL exists')
    _finish(*started['convert'], 'convert_vgg16.sh')
    done_s = time.perf_counter() - t_start
    with np.load(osp.join(work, 'vgg16_script.npz')) as a, \
            np.load(osp.join(work, 'vgg16_direct.npz')) as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f'convert_vgg16.sh: entries {a.files} '
                                 f'against {b.files}')
        for k in a.files:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f'convert_vgg16.sh: {k} differs')
        entries = len(a.files)
    log(f'convert_vgg16.sh on a seeded full-width vgg16 V2 checkpoint '
        f'({source_mb:.1f} MB): {entries} entries, bit-equal to the direct '
        f'cli.convert\'s (in process, {direct_s:.2f} s, '
        f'{source_mb / direct_s:.1f} MB/s); the driver\'s process done '
        f'{done_s:.2f} s after its start, beside the phase\'s other work; '
        f'train_faster_rcnn.sh took its NET_FINAL skip  [{card}]')
    return dict(entries=entries, source_mb=source_mb, done_s=done_s,
                direct_s=direct_s, launches={})


def example_smoke_5i(card: str) -> dict:
    """tpudenoise_torch/examples/smoke.py's main() in process: kernel 1
    once, kernel 3 and the walk twice (nms_fixpoint and nms_packed), the
    smoke's own card-against-CPU checks, every launch held to its plain
    version."""
    import io

    from tpudenoise_torch.examples import smoke as example_smoke
    buf = io.StringIO()
    with taped() as calls, contextlib.redirect_stdout(buf):
        rc, wall, counts, _ = run_cli(lambda argv: example_smoke.main(),
                                      [])
    if rc != 0 or 'SMOKE OK' not in buf.getvalue():
        raise AssertionError(f'examples/smoke.py: {rc}\n{buf.getvalue()}')
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    if launches != {'fused_sap_median_batched': 1, MASKS: 2, WALK: 2}:
        raise AssertionError(f'examples/smoke.py: launches {launches}')
    # the smoke's CPU half calls the same wrappers: hold the card's calls
    held = hold_to_plain({k: [c for c in v if c[2].is_cuda]
                          for k, v in calls.items()}, 'examples/smoke.py',
                         card)
    print(buf.getvalue(), end='', flush=True)
    log(f'examples/smoke.py: SMOKE OK in {wall:.2f} s; launches '
        f'{json.dumps(launches)}  [{card}]')
    return dict(wall_s=wall, launches=launches, held=held)


def train_snapshot(tag: str, iters: int) -> str:
    """The prefix of the snapshot that `train_cli` writes with tag after
    iters iterations (under build/chip_smoke_train)."""
    import os.path as osp
    cfg = default_config()
    cfg.ROOT_DIR = osp.join(cfg.ROOT_DIR, 'build', 'chip_smoke_train')
    cfg.EXP_DIR = 'res101'
    return osp.join(get_output_dir('rrData_2021_trainval', tag, cfg),
                    f'res101_faster_rcnn_iter_{iters}')


# the seeded vgg16 source of convert_vgg16.sh, written in a process of its
# own (numpy and the checkpoint writer only)
WRITE_VGG16 = ('import sys; from tpudenoise_torch.data.synthetic import '
               'write_vgg16_checkpoint; write_vgg16_checkpoint(sys.argv[1], '
               'seed=19)')


def slice19_phase(card: str, cli: dict, loop: dict, snapshot: str) -> dict:
    """Phase 5i: the rpn proposal method (proposals of a seeded res101,
    evaluate_recall card against CPU, an rpn training roidb and two
    iterations on the card), examples/smoke.py, cli.reval --nms on three
    routes, and the three drivers of tpudenoise_torch/experiments/scripts
    run for real in a scratch directory, as processes beside this one's
    card work: the test driver on `snapshot` (a 2-iteration cli.trainval
    snapshot) placed where it looks, the train driver on its NET_FINAL
    skip, the convert driver on a seeded full-width vgg16 that another
    process writes first (the direct cli.convert runs in this process
    while the drivers do)."""
    import os.path as osp
    import pickle
    import shutil
    import subprocess
    import threading
    t0 = time.perf_counter()
    if not osp.exists(snapshot + '.pt'):
        raise AssertionError(f'phase 5i: no snapshot {snapshot}.pt')
    repo = default_config().ROOT_DIR
    work = osp.join(repo, 'build', 'chip_smoke_scripts')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    src = osp.join(work, 'vgg_16.ckpt')
    log_file = open(osp.join(work, 'vgg16_writer.log'), 'w')
    started = {'writer': (subprocess.Popen(
        [sys.executable, '-c', WRITE_VGG16, src], cwd=work,
        env={**os.environ, 'PYTHONPATH': repo}, stdout=log_file,
        stderr=subprocess.STDOUT), log_file)}
    started.update(start_drivers(cli, snapshot, work))
    t_converts = []

    def then_convert():
        # waiting on the writer releases the GIL
        if started['writer'][0].wait() == 0:
            t_converts.append(time.perf_counter())
            started.update(start_convert(work, src))

    chain = threading.Thread(target=then_convert)
    chain.start()
    out = {}
    try:
        proposals, out['rpn proposals'] = proposals_5i(card, loop)
        rpn_file = osp.join(loop['root'], 'rpn_proposals.pkl')
        with open(rpn_file, 'wb') as f:
            pickle.dump(proposals, f)
        out['evaluate_recall'] = recall_5i(card, loop, proposals)
        out['train rpn roidb'] = rpn_training_5i(card, loop, rpn_file)
        out['examples/smoke.py'] = example_smoke_5i(card)
        # the direct cli.convert while the drivers run
        chain.join()
        _finish(*started['writer'], 'the vgg16 source writer')
        direct_s = direct_convert_5i(work, src)
        out['test_faster_rcnn.sh'], out_dir = test_driver_5i(
            card, cli, work, started, t0)
        out.update(reval_5i(card, cli, out_dir))
        out['convert_vgg16.sh'] = convert_driver_5i(
            card, work, started, t_converts[0],
            osp.getsize(src + '.data-00000-of-00001') / 1e6, direct_s)
    finally:
        chain.join()
        for proc, f in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    wall = time.perf_counter() - t0
    log(f'phase 5i: {wall:.1f} s (budget {PHASE_5I_S:.0f} s'
        + (', over it' if wall > PHASE_5I_S else '') + f')  [{card}]')
    return out


# ------------------------------------------------ slice 17: phase 5g --

# the data-parallel phase: training iterations a run, the timed
# repetitions of the spatial filters and the all-reduce, the loss terms
# held, and the time a group of ranks may take
DP_ITERS = 3
DP_REPS = 5
DP_LOSSES = ('rpn_cross_entropy', 'rpn_loss_box', 'cross_entropy',
             'loss_box', 'total_loss')
# the world of two against one process on the same global batch, both
# with the model and its class heads in f32 (in bf16 a rank's one-image
# convolutions and the one process's two-image ones round apart:
# cross_entropy 1.6e-3 apart at step 1; with bf16 heads alone, 1.15e-4):
# step 1 (from the same parameters) every loss term within this relative
# bound, later steps the RPN terms.  After step 1 the parameters differ
# by rounding, and a proposal whose score ties another's within it can
# swap places among the sampled RoIs: one of two runs on an H100 took
# another sample at step 2 (cross_entropy 3.6e-2 apart, the RPN terms
# 1e-7), so the RoI terms of later steps are logged, not held
DP_LOSS_RTOL = 1e-4
DP_RPN_LOSSES = ('rpn_cross_entropy', 'rpn_loss_box')
DP_TIMEOUT = 600
# the worlds: (ranks, backend); two ranks share the one card under gloo
# (NCCL takes one GPU a rank), a check of correctness, not of scaling
DP_WORLDS = ((1, 'nccl'), (2, 'gloo'))
SPATIAL_KINDS = ('median', 'mean', 'gaussian')


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def param_hashes(model, params: dict) -> dict:
    """sha256 of every parameter's bytes (sorted by name), and of the
    frozen ones alone."""
    import hashlib

    def digest(names):
        h = hashlib.sha256()
        for n in sorted(names):
            h.update(params[n].detach().cpu().numpy().tobytes())
        return h.hexdigest()
    return dict(all=digest(params),
                frozen=digest(n for n, _ in model.named_parameters()
                              if model.frozen(n)))


def launch_ranks(world: int, backend: str, spec: dict) -> list:
    """The ranks of one process group, a process each, in torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    `python3 chip_smoke.py --rank SPEC` (`rank_main`).  A rank that
    fails ends the others and fails the phase; so does a group that runs
    past DP_TIMEOUT.  Returns each rank's result."""
    import os.path as osp
    import shutil
    import subprocess
    work = osp.join(default_config().ROOT_DIR, 'build', 'chip_smoke_dp',
                    f'world{world}')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    spec = dict(spec, work=work, world=world, backend=backend)
    with open(osp.join(work, 'spec.json'), 'w') as f:
        json.dump(spec, f)
    env = {**os.environ, 'WORLD_SIZE': str(world),
           'MASTER_ADDR': 'localhost', 'MASTER_PORT': str(_free_port())}
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(osp.join(work, f'rank{r}.log'), 'w'))
            procs.append(subprocess.Popen(
                [sys.executable, osp.abspath(__file__), '--rank',
                 osp.join(work, 'spec.json')],
                env={**env, 'RANK': str(r), 'LOCAL_RANK': str(r)},
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.time() + DP_TIMEOUT
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0)
                                             for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(osp.join(work, f'rank{r}.log')) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f'5g: rank {r} of {world} ({backend}) '
                                 f'exited {p.returncode}:\n{text[-6000:]}')
        for line in text.splitlines():
            if line.startswith('5g'):
                log(f'[rank {r}] {line}')
    out = []
    for r in range(world):
        with open(osp.join(work, f'rank{r}.json')) as f:
            out.append(json.load(f))
    return out


def _median_ms(fn, reps: int = DP_REPS) -> float:
    """The median wall time of fn() in ms, the card synchronized at both
    ends of each call, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        times.append(_timed(fn)[1] * 1e3)
    return statistics.median(times)


def dp_spatial(mesh, dev, card: str, world: int) -> dict:
    """Each spatial filter on (B, H, W, 3) u8-valued floats, H split over
    the ranks: gathered, bit-equal to the single-device stencil; the
    sharded call and the stencil timed."""
    from tpudenoise_torch.core import mesh as M
    from tpudenoise_torch.denoise import stencils
    from tpudenoise_torch.parallel.spatial import (gather_spatial,
                                                   make_spatial_filter,
                                                   spatial_block)
    imgs = torch.from_numpy(np.random.RandomState(17).randint(
        0, 256, (B, H, W, 3)).astype(np.float32)).to(dev)
    ref = {'median': stencils.median3, 'mean': stencils.mean3,
           'gaussian': stencils.gaussian_blur3}
    out = {}
    for kind in SPATIAL_KINDS:
        fn = make_spatial_filter(mesh, kind)
        block = spatial_block(mesh, imgs)
        got = gather_spatial(mesh, fn(block))
        want = ref[kind](imgs)
        if not torch.equal(got, want):
            raise AssertionError(f'5g world {world}: spatial {kind} differs '
                                 f'from the single-device stencil')
        out[kind] = dict(sharded_ms=_median_ms(lambda: fn(block)),
                         one_device_ms=_median_ms(lambda: ref[kind](imgs)),
                         rows=block.shape[1])
        log(f'5g world {world}: spatial {kind} on {tuple(imgs.shape)}, '
            f'{block.shape[1]} rows a rank, gathered bit-equal to the '
            f'stencil; sharded {out[kind]["sharded_ms"]:.3f} ms, one device '
            f'{out[kind]["one_device_ms"]:.3f} ms  [{card}]')
        M.agree(True, dev)
    return out


def dp_all_reduce(dev, card: str, world: int) -> dict:
    """One all-reduce of a buffer the size of res101's trainable
    gradients (f32), as the data-parallel step makes it, timed."""
    import torch.distributed as dist
    model = FasterRCNN('res101', num_classes=2)
    n = sum(p.numel() for name, p in model.named_parameters()
            if not model.frozen(name))
    flat = torch.ones(n, device=dev)
    ms = _median_ms(lambda: dist.all_reduce(flat))
    if not torch.all(flat == world ** (DP_REPS + 1)):
        raise AssertionError(f'5g world {world}: the all-reduce summed '
                             f'wrong')
    log(f'5g world {world} ({dist.get_backend()}): one all-reduce of '
        f'res101\'s {n} trainable gradients ({n * 4 / 1e6:.1f} MB f32): '
        f'{ms:.3f} ms  [{card}]')
    return dict(elements=n, ms=ms, backend=dist.get_backend())


def dp_eval_argv(cli: dict, exp: str, extra=()) -> list:
    import os.path as osp
    return list(extra) + [
        '--net', 'res101', '--cfg', osp.join(cli['repo'], 'experiments',
                                             'cfgs', 'res101.yml'),
        '--imdb', 'rrData_2021_test', '--noise', LOOP_NOISE,
        '--eval-batch', str(B), '--model', cli['npz'], '--set', 'DATA_DIR',
        cli['root'], 'ROOT_DIR', cli['root'], 'EXP_DIR', exp]


def dp_eval(cli: dict, card: str, exp: str, extra=()) -> dict:
    """cli.test over the CLI phase's images with the CLI phase's weights
    (with extra flags), twice: the first call warms the process (cuDNN's
    choices, the first launches), the second is timed (its
    test_net_batched loop) and every launch of it held to its plain
    version; where rank 0 wrote detections.pkl."""
    import os.path as osp

    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.eval import harness
    path = f'5g cli.test {" ".join(extra)} --eval-batch {B}'
    run_cli(cli_test.main, dp_eval_argv(cli, exp, extra))
    loop = []
    with taped() as calls, patched(harness, 'test_net_batched',
                                   lambda fn: timing(fn, loop)):
        aps, wall, counts, cfg = run_cli(cli_test.main,
                                         dp_eval_argv(cli, exp, extra))
    held = hold_to_plain(calls, path, card)
    launches = {k: counts[k] for k in ('fused_sap_median_batched',)
                + NMS_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f'{path} launches {launches}')
    (eval_s,) = loop
    dets = osp.join(get_output_dir('rrData_2021_test',
                                   cli['npz'].replace('/', '_'), cfg),
                    'detections.pkl')
    log(f'{path}: test_net_batched {eval_s:.2f} s over {CLI_IMAGES} images '
        f'({CLI_IMAGES / eval_s:.1f} img/s, {CLI_IMAGES / B / eval_s:.2f} '
        f'chunks/s), launches {json.dumps(launches)}  [{card}]')
    return dict(aps=aps, wall_s=wall, eval_s=eval_s,
                img_per_s=CLI_IMAGES / eval_s, launches=launches, held=held,
                detections=dets)


@contextlib.contextmanager
def f32_detector(on: bool = True):
    """The CLIs' FasterRCNN built in f32, its class heads too (the CLIs
    build bf16, and the heads in bf16 whatever the model's dtype), while
    the block runs, when on."""
    import tpudenoise_torch.models.faster_rcnn as fr
    if not on:
        yield
        return

    def f32(cls):
        def build(*a, **k):
            model = cls(*a, **{**k, 'dtype': torch.float32})
            model.rcnn.dtype = torch.float32
            return model
        return build

    with patched(fr, 'FasterRCNN', f32):
        yield


def dp_train(inp: dict, card: str, tag: str, batch: int, extra=(),
             check: bool = True) -> dict:
    """cli.trainval res101 on the training phase's images, DP_ITERS
    iterations at --batch batch (and extra flags), every launch held;
    its losses, step times and parameter hashes.  At batch 2 the model is
    f32 (DP_LOSS_RTOL)."""
    with f32_detector(batch > 1):
        e, state, seen, *_ = train_cli(card, inp, 'res101', TRAIN_NOISE,
                                       DP_ITERS, tag,
                                       extra=['--batch', str(batch), *extra],
                                       check=check)
    e['step_s'] = [b['t'] - a['t'] for a, b in zip(seen, seen[1:])]
    e['hashes'] = param_hashes(FasterRCNN('res101', num_classes=2),
                               state.params)
    del state
    torch.cuda.empty_cache()
    return e


def rank_main(spec_path: str) -> int:
    """One rank of phase 5g (`launch_ranks`): joins the group from
    torchrun's environment, then the spatial filters, the all-reduce,
    cli.test and cli.trainval with --distributed; writes its results
    beside the spec."""
    import os.path as osp

    import torch.distributed as dist

    from tpudenoise_torch.core import mesh as M
    with open(spec_path) as f:
        spec = json.load(f)
    world, backend = spec['world'], spec['backend']
    set_matmul_precision()
    card = card_line()
    cuda_build.build(SOURCES)
    dev = M.initialize_distributed(backend=backend)
    flags = ['--distributed', '--dist-backend', backend]
    try:
        mesh = M.make_mesh()
        out = dict(rank=M.rank(), device=str(dev),
                   spatial=dp_spatial(mesh, dev, card, world),
                   all_reduce=dp_all_reduce(dev, card, world))
        zero_counts()
        out['eval'] = dp_eval(spec['cli'], card, f'dp{world}', flags)
        out['train'] = dp_train(spec['train'], card, f'dp{world}', world,
                                flags)
    finally:
        dist.destroy_process_group()
    with open(osp.join(spec['work'], f'rank{out["rank"]}.json'), 'w') as f:
        json.dump(out, f, default=str)
    return 0


def _sum_launches(entries) -> dict:
    total = {}
    for e in entries:
        for k, v in e['launches'].items():
            total[k] = total.get(k, 0) + v
    return total


def dp_phase(card: str, cli: dict) -> dict:
    """Phase 5g, data parallelism on the card.  References in this
    process: cli.trainval res101 at --batch 1 and --batch 2 (DP_ITERS
    iterations each) and cli.test over the CLI phase's 16 images.  Then
    each world of DP_WORLDS as a group of processes (`rank_main`):
    cli.trainval --distributed --batch <ranks>, held to the reference of
    that batch (the world of one bit for bit: no mesh; the world of two,
    the same global batch and fold_in keys, step 1's loss terms and the
    later steps' RPN terms within DP_LOSS_RTOL, every frozen parameter
    bit-equal, the ranks' parameters bit-equal); cli.test --distributed
    --eval-batch 8, its detections matching the reference's at phase 4's
    tolerance; the spatial
    filters bit-equal to the stencils; one all-reduce timed.  Every
    kernel launch of every run is held to its plain version."""
    import pickle
    inp = train_inputs()
    out, info = {}, {}
    t0 = time.perf_counter()
    ref_train = {b: dp_train(inp, card, f'ref{b}', b, check=b == 1)
                 for b in (1, 2)}
    for b, e in ref_train.items():
        out[f'5g train one process --batch {b}'] = e
    ref_eval = dp_eval(cli, card, 'dp_ref')
    out['5g cli.test one process'] = ref_eval
    with open(ref_eval['detections'], 'rb') as f:
        want = pickle.load(f)[1]
    torch.cuda.empty_cache()
    for world, backend in DP_WORLDS:
        name = f'world {world} ({backend})'
        ranks = launch_ranks(world, backend, dict(cli=cli, train=inp))
        trains = [r['train'] for r in ranks]
        ref = ref_train[world]
        for r, t in enumerate(trains):
            if t['hashes']['all'] != trains[0]['hashes']['all']:
                raise AssertionError(f'5g {name}: rank {r}\'s parameters '
                                     f'differ from rank 0\'s')
            if t['hashes']['frozen'] != ref['hashes']['frozen']:
                raise AssertionError(f'5g {name}: frozen parameters moved')
        rels = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                 for k in DP_LOSSES}
                for g, w in zip(trains[0]['losses'], ref['losses'])]
        held = max([max(rels[0].values())]
                   + [r[k] for r in rels[1:] for k in DP_RPN_LOSSES])
        rel = max(v for r in rels for v in r.values())
        if world == 1:
            if (trains[0]['losses'] != ref['losses']
                    or trains[0]['hashes'] != ref['hashes']):
                raise AssertionError(f'5g {name}: not bit-equal to the '
                                     f'steps without --distributed')
        elif not held <= DP_LOSS_RTOL:
            raise AssertionError(f'5g {name}: losses {trains[0]["losses"]} '
                                 f'against {ref["losses"]} (rel '
                                 f'{held:.2e})')
        with open(ranks[0]['eval']['detections'], 'rb') as f:
            got = pickle.load(f)[1]
        matched, total = _match_dets(want, got)
        if total == 0 or matched / total < 0.95:
            raise AssertionError(f'5g {name}: {matched}/{total} detections '
                                 f'match the one-process run\'s')
        step = statistics.median(s for t in trains[:1] for s in t['step_s'])
        log(f'5g {name}: cli.trainval --distributed --batch {world}, '
            f'{DP_ITERS} iterations, losses against one process '
            f'(--batch {world}) within {rel:.2e} relative'
            + (' (bit-equal, parameters too)' if world == 1 else
               f', step 1 and the later RPN terms within {held:.2e} (bound '
               f'{DP_LOSS_RTOL}); step by step {json.dumps(rels)}; frozen '
               f'parameters bit-equal, the ranks\' parameters bit-equal')
            + f'; step {step * 1e3:.1f} ms (one process: '
            f'{statistics.median(ref["step_s"]) * 1e3:.1f} ms); cli.test '
            f'--distributed: {matched}/{total} detections match, '
            f'{ranks[0]["eval"]["img_per_s"]:.1f} img/s (one process '
            f'{ref_eval["img_per_s"]:.1f})'
            + ('; two ranks share one card: a check of correctness, not '
               'of scaling' if world > 1 else '') + f'  [{card}]')
        out[f'5g train {name}'] = dict(
            launches=_sum_launches(trains), losses=trains[0]['losses'],
            loss_rel_err=rels, step_s=[t['step_s'] for t in trains],
            held=[t['held'] for t in trains])
        out[f'5g cli.test {name}'] = dict(
            launches=_sum_launches(r['eval'] for r in ranks),
            img_per_s=ranks[0]['eval']['img_per_s'],
            matched=[matched, total], held=[r['eval']['held'] for r in ranks])
        info[name] = dict(spatial=ranks[0]['spatial'],
                          all_reduce=ranks[0]['all_reduce'],
                          step_ms=step * 1e3,
                          eval_img_per_s=ranks[0]['eval']['img_per_s'])
    info['wall_s'] = time.perf_counter() - t0
    log(f'phase 5g: {info["wall_s"]:.1f} s of wall time  [{card}]')
    log(json.dumps({'5g': info}, default=str))
    return out


# symbols of the port's own kernels (csrc/*.cu), as the profiler names
# them; a name that holds another comes first
OWN_KERNELS = ('sap_median_kernel', 'gauss_blur_kernel', 'mask_kernel',
               'greedy_kernel',
               'mix_noise_kernel', 'mix_bilateral_kernel', 'brownian_',
               'bloom_kernel', 'bilateral_kernel', 'threefry_kernel',
               SAP_STAGES[0])


def profile_paths(inputs, card: str, noises, tag: str = '') -> dict:
    """Where a chunk's device time goes: for each noise string, one warm
    chunk, then one chunk (images 24-31) under torch.profiler, the device's
    activity only.  Reports the chunk's wall time (the profiler's own cost
    included), the device
    kernel time, the device's idle share of the wall time, the port's own
    kernels' time and the largest kernels by device time, and the time the
    profiler took to start (the first session in a process sets up
    CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    model, params, raw, levels, key = inputs
    out = {}
    for noise in noises:
        fn = make_pipeline(noise)
        name = tag + noise

        def chunk(it):
            detect_chunk(model, params, key, list(range(B * it, B * it + B)),
                         raw, levels, fn)

        chunk(2)
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type.name == 'CUDA' and e.self_device_time_total]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        # the port's own kernels by name (each kernel under the first
        # name it holds): (ms, launches) a chunk
        own_by = {}
        for e in kern:
            k = next((k for k in OWN_KERNELS if k in e.key), None)
            if k:
                t, c = own_by.get(k, (0.0, 0.0))
                own_by[k] = (t + e.self_device_time_total / 1e3,
                             c + e.count)
        own = sum(t for t, _ in own_by.values())
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = dict(
            profiler_start_s=t0 - t_in,
            wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
            own_kernels_ms=own, own_by_kernel=own_by,
            kernel_names=len(kern),
            top=[(e.key[:90], e.self_device_time_total / 1e3, e.count)
                 for e in top])
        log(f'profile {name}: profiler start {t0 - t_in:.2f} s; chunk '
            f'{wall:.2f} ms, device {busy:.2f} ms, '
            f'idle {1.0 - busy / wall:.1%}, port kernels {own:.3f} ms; top '
            f'(name, ms/chunk, calls): '
            + '; '.join(f'{k} {t:.3f} x{c}' for k, t, c in out[name]['top'])
            + f'  [{card}]')
        log(f'profile {name}: port kernels a chunk (ms, launches): '
            + '; '.join(f'{k} {t:.4f} x{c:g}' for k, (t, c) in own_by.items())
            + f'  [{card}]')
        if 'threefry_kernel' in own_by:
            t, c = own_by['threefry_kernel']
            log(f'profile {name}: threefry device time a chunk {t:.4f} ms in '
                f'{c:g} launches  [{card}]')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    dev = DEV
    set_matmul_precision()
    card = card_line()
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    log(f'card: {card}')

    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    log(f'build: {time.perf_counter() - t0:.1f} s '
        f'(nvcc: {json.dumps(cuda_build.build_seconds)})')

    # each phase's seconds, logged at the end
    phases, t_last = {}, [time.perf_counter()]

    def done(name):
        t = time.perf_counter()
        phases[name] = t - t_last[0]
        t_last[0] = t

    done('environment and build')
    rows = (check_kernels(dev) + check_mix_kernels(dev) + check_threefry(dev)
            + check_hash(dev) + check_sap_stages(dev))
    wavelet = check_wavelet(dev, card)
    done('3 kernels')
    check_small_chunk(dev)
    done('4 small chunks')
    vgg = chunk_inputs(dev, 'vgg16')
    e2e = main_path(vgg, card, NOISES)
    e2e[ENTRY_PATH] = entry_path(vgg[2], vgg[4])
    res = chunk_inputs(dev, 'res101')
    e2e.update(main_path(res, card, RES_NOISES, 'res101 '))
    e2e[PROFILE_PATH] = profiling_path(dev, card)
    done('5 main paths')
    loop = dataset_loop(card)
    cli = cli_inputs()
    e2e.update(cli_phase(card, cli))
    done('5 dataset loop and CLIs')
    train_paths, train_info, train_timed = train_phase(card, rows)
    e2e.update(train_paths)
    done('5b training')
    e2e.update(grid_phase(card))
    done('5c grid')
    # phase 5f before 5d, whose profiler sessions are the process's
    # first: after a session, a run of unprofiled work as long as 5f's
    # left torch.profiler dropping kernel records in the later reads
    mob = chunk_inputs(dev, 'mobile')
    e2e.update(slice16_phase(card, mob, cli))
    done('5f mobile, convert, automold')
    # phase 5h before 5d's profiler sessions too
    e2e.update(slice18_phase(card, res))
    done('5h checkpoint sources, XLA route')
    # phase 5i after 5h (whose 2-iteration cli.trainval snapshot the test
    # driver tests), before 5d's profiler sessions
    e2e.update(slice19_phase(card, cli, loop,
                             train_snapshot('converted', CONVERT_ITERS)))
    done('5i proposals, reval routes, drivers, library smoke')
    e2e.update(shape_phase(card, rows))
    done('5d shapes')
    prof = profile_paths(vgg, card, NOISES)
    prof.update(profile_paths(res, card, RES_NOISES, 'res101 '))
    prof.update(profile_paths(mob, card, MOBILE_NOISES, 'mobile '))
    del mob
    e2e.update(cli_profiled(card, cli))
    train_info['profile'] = train_profiled(card, train_timed)
    del train_timed
    done('6 profiles')
    # the kernels' device times (`later`): only now, after every timed
    # chunk but phase 5e's
    def resolve(d):
        for k, v in d.items():
            if isinstance(v, functools.partial):
                d[k] = v()
            elif isinstance(v, dict):
                resolve(v)

    for r in rows:
        resolve(r)
    done('6 kernel device times')
    # phase 5e after the device-time reads: run before them, its curvelet
    # chunks left the profiler dropping kernel records in those reads
    e2e.update(slice15_phase(card, res, cli))
    done('5e fast-rng, curvelet, compute-id')
    del res
    e2e.update(dp_phase(card, cli))
    done('5g data parallelism')
    # each kernel's launches, summed over the main paths that run it
    for r in rows:
        r['launches'] = sum(p['launches'].get(r['name'], 0)
                            for p in e2e.values())
        log(f"{r['name']}: kernel {r['ms']:.3f} ms"
            + (f" (device {r['device_ms']} ms)" if 'device_ms' in r
               else '')
            + f", plain {r['plain_ms']:.3f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} main-path launches  [{card}]")
        for key in ('train_rpn', 'pyramid_post', 'coco_post'):
            if key in r:
                t = r[key]
                log(f"  {r['name']} at {t['what']} {t['shape']}: kernel "
                    f"{t['ms']:.3f} ms (device {t['device_ms']} ms), plain "
                    f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']})  [{card}]")
        for what, t in r.get('modes', {}).items():
            log(f"  {r['name']} {what}: kernel {t['ms']:.4f} ms (device "
                f"{t['device_ms']} ms), bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})  [{card}]")
        if 'f32_ms' in r:
            log(f"  {r['name']} on f32 images: kernel {r['f32_ms']:.4f} ms "
                f"(device {r['f32_device_ms']} ms)  [{card}]")
        for stage, t in r.get('stages', {}).items():
            log(f"  {r['name']} {stage} (B={r['batch']}, tile_h="
                f"{r['tile_h']}): kernel {t['ms']:.3f} ms (device "
                f"{t['device_ms']} ms), plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library {t['library_ms']}  [{card}]")
    if not all(r['launches'] for r in rows):
        raise AssertionError('a kernel was not launched on the main path')
    log('phases (s): ' + ', '.join(f'{k} {v:.1f}' for k, v in phases.items())
        + f'  [{card}]')
    log(json.dumps({'main_path': e2e, 'dataset_loop': loop,
                    'wavelet': wavelet, 'profile': prof,
                    'training': train_info, 'card': card}, default=str))
    log(f'chip_smoke: {time.perf_counter() - t_main:.1f} s from the start '
        f'of main() to the result, the build included  [{card}]')
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def only_5g() -> int:
    """`python3 chip_smoke.py --only-5g`: the build and phase 5g alone
    (its inputs made as the whole run makes them), for working on it;
    prints no result line."""
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    set_matmul_precision()
    card = card_line()
    cuda_build.build(SOURCES)
    dp_phase(card, cli_inputs())
    return 0


def only_5i() -> int:
    """`python3 chip_smoke.py --only-5i`: the build and phase 5i alone (the
    dataset loop, the CLI and training inputs made first, as the whole run
    makes them), for working on it; prints no result line."""
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    set_matmul_precision()
    card = card_line()
    cuda_build.build(SOURCES)
    loop = dataset_loop(card)
    cli = cli_inputs()
    inp = train_inputs()
    train_cli(card, inp, 'res101', TRAIN_NOISE, CONVERT_ITERS, 'scripts')
    slice19_phase(card, cli, loop, train_snapshot('scripts', CONVERT_ITERS))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:] == ['--only-5g']:
        sys.exit(only_5g())
    if sys.argv[1:] == ['--only-5i']:
        sys.exit(only_5i())
    sys.exit(main())
