"""Train CLI on the GPU (counterpart of `tpudenoise/cli/trainval.py`): the
same flags and defaults, plus --device.

    python -m tpudenoise_torch.cli.trainval --net res101 \\
        --imdb rrData_2021_trainval --imdbval rrData_2021_test \\
        --cfg experiments/cfgs/res101.yml --iters 5000 \\
        --noise sap_median_var0.4 [--weight backbone.npz] \\
        [--device cuda|cpu] [--set KEY VALUE ...]

`--device cuda` (the default) needs a CUDA GPU and never falls back to the
CPU.  `--weight` takes a `.npz` in the shared layout, merged over the
seeded init (`models.convert.merge_pretrained`).  Snapshots go to
`output/EXP_DIR/<imdb>/<tag>/` (`train/solver.py`); a snapshot's params
written with `models.convert.save_params_npz` load in the JAX package.
On a machine without cv2, the datasets' pixels come from `python -m
tpudenoise_torch.data.cache_pixels --image-set trainval` (and the
validation set's).  `--fast-rng` draws the noise from the counter hash.

`--distributed` joins a process group from torchrun's environment (one
process a GPU, NCCL; `core.mesh.initialize_distributed`) and trains
data-parallel when `--batch` divides over the ranks:

    torchrun --nproc-per-node N -m tpudenoise_torch.cli.trainval \
        --distributed --batch N ...

`--dist-backend gloo` lets ranks share a GPU (NCCL does not), a check of
correctness rather than of speed; on the CPU gloo is the default.
"""

from __future__ import annotations

import argparse
import pprint

import numpy as np

from tpudenoise_torch.cli.test import NETS, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a Faster R-CNN network '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--cfg', dest='cfg_file', default=None,
                   help='cfg file (the YAML subset of '
                        'tpudenoise_torch.utils.cfg_reader)')
    p.add_argument('--weight', default=None,
                   help='initial weights (.npz in the shared layout)')
    p.add_argument('--imdb', dest='imdb_name',
                   default='voc_2007_trainval')
    p.add_argument('--imdbval', dest='imdbval_name',
                   default='voc_2007_test')
    p.add_argument('--iters', dest='max_iters', type=int, default=70000)
    p.add_argument('--tag', default=None)
    p.add_argument('--net', default='res50', choices=NETS)
    p.add_argument('--noise', default='original',
                   help='{noise}_{denoise}_var{level} string')
    p.add_argument('--batch', type=int, default=1,
                   help='images a batch (the reference is fixed at 1)')
    p.add_argument('--bucket', type=int, nargs=2, default=None,
                   help='static padded image bucket H W (default: derived '
                        'from TRAIN geometry and dataset orientations)')
    p.add_argument('--no-prefetch', action='store_true',
                   help='disable the threaded image-read prefetch '
                        '(exact-resume-safe, on by default)')
    p.add_argument('--fast-rng', action='store_true',
                   help='counter-hash draws for every generator of the '
                        'generic and bilateral noise routes')
    p.add_argument('--distributed', action='store_true',
                   help='join the process group of torchrun\'s environment '
                        'and train data-parallel over its ranks')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='the process group\'s backend (default nccl on '
                        'cuda, gloo on the CPU; gloo lets ranks share a '
                        'GPU)')
    p.add_argument('--dist-init-method', default=None, metavar='URL',
                   help='the process group\'s rendezvous (default env://, '
                        'torchrun\'s; file:///path needs no port)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where training runs (default cuda; no fallback)')
    p.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                   default=None, help='set config keys')
    return p.parse_args(argv)


def main(argv=None):
    """Trains; returns the final TrainState."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if not args.distributed:
        return _main(args, device)
    from tpudenoise_torch.core.mesh import process_group
    with process_group(args.dist_init_method, args.device,
                       args.dist_backend) as device:
        return _main(args, device)


def _main(args, device):
    from tpudenoise_torch.core.config import (cfg, cfg_from_file,
                                              cfg_from_list, get_output_dir,
                                              get_output_tb_dir)
    from tpudenoise_torch.data.roidb import combined_roidb
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.train.solver import train_net

    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    print('Using config:')
    pprint.pprint(cfg)
    np.random.seed(cfg.RNG_SEED)

    imdb_obj, roidb = combined_roidb(args.imdb_name, args.noise, cfg,
                                     device=device)
    print(f'{len(roidb)} roidb entries')
    output_dir = get_output_dir(imdb_obj.name, args.tag, cfg)
    tb_dir = get_output_tb_dir(imdb_obj.name, args.tag, cfg)

    # the validation roidb without flips
    orig_flip = cfg.TRAIN.USE_FLIPPED
    cfg.TRAIN.USE_FLIPPED = False
    _, valroidb = combined_roidb(args.imdbval_name, args.noise, cfg,
                                 device=device)
    cfg.TRAIN.USE_FLIPPED = orig_flip
    print(f'{len(valroidb)} validation roidb entries')

    model = FasterRCNN(backbone=args.net, num_classes=imdb_obj.num_classes,
                       anchor_scales=tuple(cfg.ANCHOR_SCALES),
                       anchor_ratios=tuple(cfg.ANCHOR_RATIOS), cfg=cfg)
    pretrained = None
    if args.weight:
        from tpudenoise_torch.models.convert import load_pretrained
        pretrained = load_pretrained(args.weight, args.net)
    return train_net(model, imdb_obj, roidb, valroidb, output_dir, tb_dir,
                     pretrained_params=pretrained, max_iters=args.max_iters,
                     noise=args.noise, config=cfg, batch_size=args.batch,
                     bucket=tuple(args.bucket) if args.bucket else None,
                     prefetch=not args.no_prefetch, device=device,
                     fast_rng=args.fast_rng)


if __name__ == '__main__':
    main()
