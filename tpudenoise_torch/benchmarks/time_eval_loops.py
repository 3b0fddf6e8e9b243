"""Time the port's two rrData evaluation loops on one GPU, for comparing
two trees of the repository on the same card.

    python tpudenoise_torch/benchmarks/time_eval_loops.py [--tree DIR]
        [--reps 3]

--tree names the root of the tree whose `tpudenoise_torch` is imported
(default: this file's own), so that one copy of this script times another
checkout; its kernels are built from that tree's sources, under its
`build/`.  Both loops run over 16 numpy-written rrData images of 600x1000
(`.npy` pixels) on sap_median_var0.4 at eval batch 8, as `chip_smoke.py`
drives them:

* the dataset loop: `test_net_batched` with a seeded vgg16 (bf16) of
  rrData's two classes, bucket (608, 1024);
* cli.test: `cli.test.main` with a seeded res101 written as `.npz`,
  experiments/cfgs/res101.yml and --eval-batch 8: its main() and its
  test_net_batched timed apart.

One warm run of each, then --reps timed runs.  Prints the card line, then
one JSON object with every run's seconds.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import shutil
import sys
import time

IMAGES, SHAPE, NOISE, BATCH = 16, (600, 1000), 'sap_median_var0.4', 8
BUCKET = (608, 1024)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--tree', default=osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))))
    p.add_argument('--reps', type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    tree = osp.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print('time_eval_loops: no CUDA device', file=sys.stderr)
        return 1
    import tpudenoise_torch
    if osp.dirname(osp.dirname(osp.abspath(tpudenoise_torch.__file__))) \
            != tree:
        raise RuntimeError(f'imported {tpudenoise_torch.__file__}, not '
                           f'the tree {tree}')
    import tpudenoise_torch.core.config as config
    from tpudenoise_torch import cuda_build
    from tpudenoise_torch.benchmarks.timing import card_line
    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import synthetic
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.voc_like import rrData
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.convert import save_params_npz
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN

    card = card_line()
    print(card, flush=True)
    cuda_build.build(('fused_noise', 'nms_mask'))
    root = osp.join(tree, 'build', 'time_eval_loops')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    pdir = default_pixel_dir('rrData_2021_test', cfg)
    synthetic.write_rrdata(root, IMAGES, SHAPE, seed=12, pixel_dir=pdir)
    npz = osp.join(root, 'res101_seeded.npz')
    save_params_npz(FasterRCNN('res101', num_classes=2).init(
        torch.Generator().manual_seed(0)), npz)

    imdb = rrData('test', config=cfg, pixel_dir=pdir)
    model = FasterRCNN('vgg16', num_classes=imdb.num_classes,
                       cfg=default_config())
    params = model.init(torch.Generator().manual_seed(0))
    model.to('cuda')
    params = {k: v.to('cuda') for k, v in params.items()}

    def dataset_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        harness.test_net_batched(model, params, imdb, 'vgg16_seeded', NOISE,
                                 eval_batch=BATCH, config=cfg, bucket=BUCKET)
        return time.perf_counter() - t0

    argv_test = ['--net', 'res101', '--cfg', osp.join(
        tree, 'experiments', 'cfgs', 'res101.yml'), '--imdb',
        'rrData_2021_test', '--noise', NOISE, '--eval-batch', str(BATCH),
        '--model', npz, '--set', 'DATA_DIR', root, 'ROOT_DIR', root]
    inner = harness.test_net_batched

    def cli():
        loop = []

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                loop.append(time.perf_counter() - t0)

        defaults = copy.deepcopy(config.cfg)
        harness.test_net_batched = timed
        try:
            t0 = time.perf_counter()
            cli_test.main(argv_test)
            return time.perf_counter() - t0, loop[0]
        finally:
            harness.test_net_batched = inner
            config.cfg.clear()
            config.cfg.update(defaults)

    dataset_loop()
    cli()
    loops = [dataset_loop() for _ in range(args.reps)]
    clis = [cli() for _ in range(args.reps)]
    out = dict(tree=tree, card=card, images=IMAGES,
               dataset_loop_s=loops,
               dataset_loop_img_per_s=[IMAGES / t for t in loops],
               cli_main_s=[m for m, _ in clis],
               cli_eval_s=[e for _, e in clis],
               cli_eval_img_per_s=[IMAGES / e for _, e in clis])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
