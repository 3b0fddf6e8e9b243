"""The noise grid on the GPU (counterpart of `experiments/noise_grid.py`):
train a detector once on clean images of the synthetic rrData-layout
fixture, then sweep the `{noise}_{denoise}_var{level}` grid through the
batched eval and record each row's AP.

    python -m tpudenoise_torch.experiments.noise_grid [--net res101]
        [--iters 5000] [--quick] [--workdir output/noise_grid_torch]
        [--device cuda|cpu] [--out-md PATH] [--out-json PATH]

The same grid, flags, cfg overrides, bucket and control rows as the JAX
script, plus `--device` (default `cuda`, no fallback).  The fixture is
`data/synthetic.write_rrdata_fixture` (the JAX fixture's images, boxes,
XML and image sets from the same stream; its pixels are the arrays
before the JPEG encoding, since the GPU machine has neither cv2 nor
PIL), written under the workdir with its `.npy` pixels in
`WORKDIR/build/pixels`.  The trained snapshot stays in the workdir and is
reused (`Solver.find_previous`), so a second run trains no step.  The
results go to `RESULTS.md` and `RESULTS.json` beside this module unless
`--out-md` / `--out-json` say otherwise (never the working directory, so
that a run from the repo root leaves the JAX package's `RESULTS.md`
alone), with the card's name and power limit and the training and sweep
wall times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import time

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))

# the README contract's intensity grid (ref README.md:90-100), one line
# per {noise}{_denoise}_var{level} eval configuration
GRID = [
    'original',
    'gaussian_var0.1', 'gaussian_var1.0', 'gaussian_var1.5',
    'gaussian_gaus_blur_var0.1', 'gaussian_gaus_blur_var1.0',
    'gaussian_gaus_blur_var1.5', 'gaussian_wavelet_var0.1',
    'sap_var0.2', 'sap_var0.4', 'sap_var0.8', 'sap_median_var0.4',
    'speckle_var0.5', 'speckle_var1.0', 'speckle_var2.0',
    'speckle_bilateral_var1.0',
    'quant_var10', 'quant_var7', 'quant_var3',
    'uniform_var0.2', 'uniform_var0.6', 'uniform_var1.2',
    'uniform_mean_var0.6',
    'brownian_var0.9', 'brownian_var0.09', 'brownian_var0.009',
    'periodic_var3.14', 'periodic_var100',
    'gamma_var0.05', 'gamma_var0.1', 'gamma_var0.2',
    'rayleigh_var0.1', 'rayleigh_var0.2', 'rayleigh_var0.3',
    'poisson',
    'bloom', 'shader',
    'noise_mix_var_low', 'noise_mix_var_medium', 'noise_mix_var_high',
    'noise_mix_var_all',
]

QUICK_GRID = ['original', 'gaussian_var0.1', 'gaussian_gaus_blur_var0.1',
              'sap_median_var0.4', 'speckle_bilateral_var1.0',
              'quant_var7', 'periodic_var100', 'noise_mix_var_medium']

# the plain-gaussian rows score ~0 by the reference's float-[0, 1] output
# quirk; each gets a control row with that output cast back to u8
CONTROLS = ('gaussian_var0.1', 'gaussian_var1.0', 'gaussian_var1.5')
BUCKET = (240, 320)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train once, sweep the noise '
                                            'grid (PyTorch/CUDA port)')
    p.add_argument('--net', default='res101')
    p.add_argument('--iters', type=int, default=5000)
    p.add_argument('--quick', action='store_true')
    p.add_argument('--workdir', default='output/noise_grid_torch')
    p.add_argument('--n-train', type=int, default=16)
    p.add_argument('--n-test', type=int, default=20)
    p.add_argument('--eval-batch', type=int, default=8)
    p.add_argument('--out-md', default=osp.join(HERE, 'RESULTS.md'))
    p.add_argument('--out-json', default=osp.join(HERE, 'RESULTS.json'))
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where training and the sweep run (default cuda; '
                        'no fallback)')
    return p.parse_args(argv)


def grid_config(workdir: str, iters: int):
    """The JAX script's cfg overrides on a fresh default config."""
    from tpudenoise_torch.core.config import default_config
    cfg = default_config()
    cfg.DATA_DIR = osp.join(workdir, 'data')
    cfg.ROOT_DIR = workdir
    cfg.TRAIN.SCALES = (BUCKET[0],)
    cfg.TRAIN.MAX_SIZE = BUCKET[1]
    cfg.TEST.SCALES = (BUCKET[0],)
    cfg.TEST.MAX_SIZE = BUCKET[1]
    cfg.TRAIN.SNAPSHOT_ITERS = max(100, iters // 2)
    # from-scratch training (no ImageNet weights): warmup and clipping,
    # and the root and block1 trainable (the reference freezes them
    # because they are pretrained)
    cfg.TRAIN.WARMUP_ITERS = 100
    cfg.TRAIN.GRAD_CLIP = 10.0
    cfg.RESNET.FIXED_BLOCKS = 0
    cfg.RESNET.FREEZE_ROOT = False
    return cfg


def dataset(split: str, cfg):
    """rrData_2021_<split> over the fixture's `.npy` pixels."""
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.voc_like import rrData
    return rrData(split, '2021', config=cfg, pixel_dir=default_pixel_dir(
        f'rrData_2021_{split}', cfg))


def write_fixture(cfg, n_train: int, n_test: int):
    """The fixture under cfg.DATA_DIR, its pixels where `dataset` reads
    them; kept when it is there already."""
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.synthetic import write_rrdata_fixture
    if osp.exists(osp.join(cfg.DATA_DIR, '6thfloorData')):
        return
    write_rrdata_fixture(cfg.DATA_DIR, n_train=n_train, n_test=n_test,
                         size=BUCKET, seed=3,
                         pixel_root=osp.dirname(default_pixel_dir('x', cfg)))


def train(args, cfg, device):
    """Train args.net for args.iters on the clean training images (or
    restore the finished snapshot); returns (model, params on device,
    seconds)."""
    from tpudenoise_torch.data.roidb import filter_roidb, get_training_roidb
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.train.solver import Solver
    d_tr = dataset('train', cfg)
    d_tr.set_proposal_method('gt')
    roidb = filter_roidb(get_training_roidb(d_tr, 'original', cfg), cfg)
    model = FasterRCNN(backbone=args.net, num_classes=2, cfg=cfg)
    solver = Solver(model, d_tr, roidb, roidb,
                    osp.join(args.workdir, f'train_{args.net}'),
                    osp.join(args.workdir, 'tb'), noise='original',
                    config=cfg, bucket=BUCKET, device=device)
    t0 = time.time()
    state = solver.train_model(max_iters=args.iters)
    seconds = time.time() - t0
    print(f'[noise_grid] trained {args.net} {args.iters} iters in '
          f'{seconds:.1f}s')
    return model.to(device), state.params, seconds


def evaluate_row(model, params, cfg, net: str, noise, eval_batch: int,
                 label: str | None = None) -> dict:
    """One grid row: `test_net_batched` over the fixture's test images
    with `noise` (a string or a parsed plan); AP@.5 and the mean over
    IoU 0.50:0.05:0.95, rounded as the JAX script rounds them."""
    from tpudenoise_torch.eval.harness import test_net_batched
    d_te = dataset('test', cfg)
    d_te.competition_mode(True)
    t0 = time.time()
    aps = test_net_batched(model, params, d_te,
                           f'{net}_grid_{label or noise}', noise,
                           eval_batch=eval_batch, config=cfg, bucket=BUCKET)
    row = {'noise': label or noise,
           'AP@.5': round(float(aps[0]), 4),
           'AP@[.5,.95]': round(float(np.mean(aps)), 4),
           'eval_s': round(time.time() - t0, 1)}
    print(f'[noise_grid] {row["noise"]}: AP@.5={row["AP@.5"]:.4f} '
          f'AP@[.5,.95]={row["AP@[.5,.95]"]:.4f}')
    return row


def control_plan(noise: str):
    """The plan of `noise` with its unit-float output cast back to u8."""
    from tpudenoise_torch.noise.spec import parse
    plan = parse(noise, mode='TEST')
    return dataclasses.replace(plan, specs=tuple(
        dataclasses.replace(s, unit_float_output=False) for s in plan.specs))


def sweep(model, params, cfg, args, grid) -> list:
    rows = [evaluate_row(model, params, cfg, args.net, noise,
                         args.eval_batch) for noise in grid]
    for g in CONTROLS:
        if any(r['noise'] == g for r in rows):
            rows.append(evaluate_row(model, params, cfg, args.net,
                                     control_plan(g), args.eval_batch,
                                     label=f'{g} (control: u8 cast)'))
    return rows


def card(device) -> str:
    if device.type != 'cuda':
        return 'cpu'
    from tpudenoise_torch.benchmarks.timing import card_line
    return card_line()


def write_results(meta: dict, out_md: str, out_json: str):
    with open(out_json, 'w') as f:
        json.dump(meta, f, indent=1)
    lines = [
        '# RESULTS — noise-grid detection AP, the PyTorch/CUDA port',
        '',
        'The sweep of `experiments/noise_grid.py` run through the port:',
        'training and evaluation on the device below, regenerable with',
        '`python -m tpudenoise_torch.experiments.noise_grid`.  Compare',
        "with the JAX package's `RESULTS.json` (bit equality is not",
        'expected: other hardware, other summation orders, and pixels',
        'without the JPEG round trip).',
        '',
        f'- device: **{meta["device"]}**',
        f'- net: **{meta["net"]}**, trained {meta["iters"]} iters on clean',
        '  fixture images (reference hyperparams: LR 1e-3, momentum 0.9,',
        f'  wd 1e-4, 2x bias LR), eval on {meta["n_test"]} held-out images.',
        f'- fixture: {meta["fixture"]}.',
        f'- wall time: training {meta["train_s"]:.1f} s (0 when a finished',
        f'  snapshot was reused), sweep {meta["sweep_s"]:.1f} s.',
        '- metric: VOC AP for class `person`, IoU 0.50:0.05:0.95 sweep',
        '  (`AP@.5` and the mean, ref lib/datasets/rrData.py:246-269).',
        '- the three gaussian_gaus_blur rows are expected to be',
        '  IDENTICAL: the reference redraws the gaussian level randomly',
        '  per test image, ignoring the parsed var (quirk, ref',
        '  test.py:1678-1682) — same key, same draws.',
        '',
        '| noise config | AP@.5 | AP@[.5,.95] |',
        '|---|---|---|',
    ]
    for r in meta['results']:
        lines.append(f'| {r["noise"]} | {r["AP@.5"]:.4f} '
                     f'| {r["AP@[.5,.95]"]:.4f} |')
    with open(out_md, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    print(f'[noise_grid] wrote {out_md} and {out_json}')


def main(argv=None) -> dict:
    """Train (or restore), sweep, write the results; returns them."""
    args = parse_args(argv)
    if args.quick:
        args.net = 'vgg16'
        args.iters = min(args.iters, 300)
    grid = QUICK_GRID if args.quick else GRID
    from tpudenoise_torch.cli.test import resolve_device
    device = resolve_device(args.device)
    args.workdir = osp.abspath(args.workdir)
    cfg = grid_config(args.workdir, args.iters)
    write_fixture(cfg, args.n_train, args.n_test)
    model, params, train_s = train(args, cfg, device)
    t0 = time.time()
    rows = sweep(model, params, cfg, args, grid)
    sweep_s = time.time() - t0
    print(f'[noise_grid] swept {len(rows)} rows in {sweep_s:.1f}s')
    meta = {'net': args.net, 'iters': args.iters,
            'n_train': args.n_train, 'n_test': args.n_test,
            'fixture': ('tpudenoise_torch.data.synthetic.'
                        'write_rrdata_fixture seed=3 240x320, pre-JPEG '
                        '.npy pixels'),
            'train_noise': 'original', 'device': card(device),
            'train_s': round(train_s, 1), 'sweep_s': round(sweep_s, 1),
            'results': rows}
    write_results(meta, args.out_md, args.out_json)
    return meta


if __name__ == '__main__':
    main()
