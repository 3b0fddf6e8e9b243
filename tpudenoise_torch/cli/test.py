"""Test/eval CLI on the GPU (counterpart of `tpudenoise/cli/test.py`): the
same flags and defaults, a `.npz` of weights, and the eval harness.

    python -m tpudenoise_torch.cli.test --net res101 \\
        --cfg experiments/cfgs/res101.yml --imdb rrData_2021_test \\
        --model weights.npz --noise sap_median_var0.4 --eval-batch 8 \\
        [--device cuda|cpu] [--profile DIR] [--set KEY VALUE ...]

`--eval-batch 1` (the default) runs `test_net`, the one-image loop, and
larger batches `test_net_batched`; `--host-prep` runs `test_net_batched`
(at any `--eval-batch`) with the JAX package's host prep, cv2's resize,
which needs cv2: a CPU parity path (the GPU machine has no cv2, and there
it fails with an ImportError naming cv2).  `--distributed` joins the
process group of torchrun's environment and splits each chunk over its
ranks (rank 0 writes detections.pkl and evaluates):

    torchrun --nproc-per-node N -m tpudenoise_torch.cli.test \
        --distributed --eval-batch 8 ...

`--dist-backend gloo` lets ranks share a GPU.  `--set TEST.SCALES
"(480, 600)"` runs a test pyramid; `voc_*` and `coco_*` datasets come in many image shapes,
which both loops take through noise buckets.  `--fast-rng` draws the
noise from the counter hash; `--compute-id` reports the backbone's TwoNN
intrinsic dimension per probe layer after the loop.  `--device cuda` (the
default) needs a CUDA GPU and never falls back to the CPU.  Weights come
as a `.npz` in the shared layout (written by
`tpudenoise.models.convert.save_params_npz` on a host with JAX, or by
`tpudenoise_torch.models.convert.save_params_npz`; a backbone-only file
is merged over the seeded init) or as the prefix of a snapshot of the
port's `cli.trainval` (`PREFIX.pt`), the form
`tpudenoise_torch/experiments/scripts/test_faster_rcnn.sh` passes.  On a
machine without cv2, the dataset's
pixels come from `python -m tpudenoise_torch.data.cache_pixels`.
"""

from __future__ import annotations

import argparse
import pprint

import numpy as np

NETS = ['vgg16', 'res50', 'res101', 'res152', 'mobile']


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test a Faster R-CNN network '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--cfg', dest='cfg_file', default=None,
                   help='cfg file (the YAML subset of '
                        'tpudenoise_torch.utils.cfg_reader)')
    p.add_argument('--model', default=None,
                   help='.npz weights, or the prefix of a cli.trainval '
                        'snapshot (PREFIX.pt) (random if unset; orbax '
                        'snapshots must be converted to .npz on a host '
                        'with JAX)')
    p.add_argument('--imdb', dest='imdb_name', default='voc_2007_test')
    p.add_argument('--comp', dest='comp_mode', action='store_true')
    p.add_argument('--num_dets', dest='max_per_image', type=int,
                   default=100)
    p.add_argument('--tag', default='')
    p.add_argument('--net', default='res50', choices=NETS)
    p.add_argument('--noise', default='original')
    p.add_argument('--strict-ref', action='store_true',
                   help='reproduce the reference test-path quirks')
    p.add_argument('--compute-id', action='store_true',
                   help='TwoNN intrinsic dimension per backbone probe '
                        'layer, reported after the eval')
    p.add_argument('--profile', default=None, metavar='DIR',
                   help='write a torch.profiler Chrome trace of the eval '
                        'into DIR')
    p.add_argument('--fast-rng', action='store_true',
                   help='counter-hash draws for every generator of the '
                        'generic and bilateral noise routes')
    p.add_argument('--host-prep', action='store_true',
                   help='cv2 resize on the host instead of the device '
                        'prep (the batched harness; needs cv2)')
    p.add_argument('--eval-batch', type=int, default=1,
                   help='images a chunk of the batched harness; 1 runs '
                        'test_net, the one-image loop')
    p.add_argument('--distributed', action='store_true',
                   help='join the process group of torchrun\'s environment '
                        'and split each chunk over its ranks')
    p.add_argument('--dist-backend', default=None, choices=['nccl', 'gloo'],
                   help='the process group\'s backend (default nccl on '
                        'cuda, gloo on the CPU; gloo lets ranks share a '
                        'GPU)')
    p.add_argument('--dist-init-method', default=None, metavar='URL',
                   help='the process group\'s rendezvous (default env://, '
                        'torchrun\'s; file:///path needs no port)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where the eval runs (default cuda; no fallback)')
    p.add_argument('--set', dest='set_cfgs', nargs=argparse.REMAINDER,
                   default=None)
    return p.parse_args(argv)


def resolve_device(name: str):
    """torch.device(name); exits non-zero, naming the GPU, when name is
    'cuda' and torch sees none."""
    import torch
    if name == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: torch sees no CUDA GPU here; the '
                         'CLI does not fall back to the CPU (pass --device '
                         'cpu to run there)')
    return torch.device(name)


def load_params(model, model_path, net, generator, image_shape=(608, 1024)):
    """The seeded init with the `.npz` at model_path merged over it, or
    the params of the port's training snapshot `model_path.pt` (the
    prefix `cli.trainval` writes, as the JAX CLI reads `model_path.orbax`
    from its own)."""
    import os.path as osp

    import torch
    params = model.init(generator, image_shape=image_shape)
    if not model_path:
        print('WARNING: no --model given; evaluating random weights')
        return params, 'random'
    if not model_path.endswith('.npz') and osp.exists(model_path + '.pt'):
        saved = torch.load(model_path + '.pt', map_location='cpu',
                           weights_only=False)['params']
        if set(saved) != set(params):
            raise ValueError(f'{model_path}.pt: its params are not those of '
                             f'--net {net} with this dataset\'s classes')
        print(f'Restored the params of snapshot {model_path}.pt')
        return {k: saved[k].to(v.dtype) for k, v in params.items()}, \
            model_path
    from tpudenoise_torch.models.convert import (load_pretrained,
                                                 merge_pretrained)
    return merge_pretrained(params, load_pretrained(model_path, net)), \
        model_path


def main(argv=None):
    """Runs the eval; returns the APs (None on ranks other than 0)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if not args.distributed:
        return _main(args, device)
    from tpudenoise_torch.core.mesh import process_group
    with process_group(args.dist_init_method, args.device,
                       args.dist_backend) as device:
        return _main(args, device)


def _main(args, device):
    import torch
    from tpudenoise_torch.core.config import cfg, cfg_from_file, cfg_from_list
    from tpudenoise_torch.data.factory import get_imdb
    from tpudenoise_torch.eval.harness import test_net, test_net_batched
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.utils.profiling import trace

    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    print('Using config:')
    pprint.pprint(cfg)
    np.random.seed(cfg.RNG_SEED)

    imdb_obj = get_imdb(args.imdb_name)
    imdb_obj.competition_mode(args.comp_mode)

    model = FasterRCNN(backbone=args.net,
                       num_classes=imdb_obj.num_classes,
                       anchor_scales=tuple(cfg.ANCHOR_SCALES),
                       anchor_ratios=tuple(cfg.ANCHOR_RATIOS), cfg=cfg)
    params, tag = load_params(model, args.model, args.net,
                              torch.Generator().manual_seed(cfg.RNG_SEED))
    model.to(device)
    params = {k: v.to(device) for k, v in params.items()}
    weights_name = (args.tag or tag or 'default').replace('/', '_')
    with trace(args.profile):
        if args.eval_batch > 1 or args.host_prep:
            return test_net_batched(model, params, imdb_obj, weights_name,
                                    args.noise, eval_batch=args.eval_batch,
                                    max_per_image=args.max_per_image,
                                    config=cfg, strict_ref=args.strict_ref,
                                    compute_id=args.compute_id,
                                    device_prep=not args.host_prep,
                                    fast_rng=args.fast_rng)
        return test_net(model, params, imdb_obj, weights_name, args.noise,
                        max_per_image=args.max_per_image, config=cfg,
                        strict_ref=args.strict_ref,
                        compute_id=args.compute_id, fast_rng=args.fast_rng)


if __name__ == '__main__':
    main()
