"""Re-evaluation CLI on the GPU (counterpart of `tpudenoise/cli/reval.py`,
ref tools/reval.py): reload a saved detections.pkl and re-run the
dataset's evaluation without the network, optionally re-applying NMS.

    python -m tpudenoise_torch.cli.reval OUTPUT_DIR --imdb rrData_2021_test \\
        [--comp] [--nms] [--device cuda|cpu]

The same arguments as the JAX CLI, plus `--device` (default `cuda`, which
needs a CUDA GPU and never falls back to the CPU).  `--nms` re-applies
NMS at `cfg.TEST.NMS` per class and image, after dropping degenerate
boxes (x2 <= x1 or y2 <= y1).  On `--device cuda` it runs as
`ops.nms.nms_dets`, kernel 3 and the walk on the card.  On `--device
cpu` it follows `cfg.USE_NATIVE_NMS` as the JAX CLI does: set (the
default), the host C++ NMS `ops.native.nms_host`; unset, the numpy
`ops.nms.nms_py`.  All three keep the same boxes where no two scores
tie; on tied scores `nms_dets` and `nms_host` take the tied boxes in
input order, `nms_py` in the order numpy's sort leaves.  The dataset
comes from `get_imdb` with the module-level `cfg` (`core/config.py`), as
the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Re-evaluate results '
                                            '(PyTorch/CUDA port)')
    p.add_argument('output_dir', help='directory containing detections.pkl')
    p.add_argument('--imdb', dest='imdb_name', default='voc_2007_test')
    p.add_argument('--comp', dest='comp_mode', action='store_true')
    p.add_argument('--nms', dest='apply_nms', action='store_true',
                   help='re-apply NMS before evaluating')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where --nms runs (default cuda; no fallback)')
    return p.parse_args(argv)


def nms_function(device):
    """The NMS of `--nms` on device: `nms_dets` on the card; on the CPU
    `nms_host` under cfg.USE_NATIVE_NMS, else `nms_py`."""
    import torch

    from tpudenoise_torch.core.config import cfg
    from tpudenoise_torch.ops.native import nms_host
    from tpudenoise_torch.ops.nms import nms_dets, nms_py
    if torch.device(device).type != 'cpu':
        return lambda dets, thresh: nms_dets(dets, thresh, device)
    return nms_host if cfg.USE_NATIVE_NMS else nms_py


def apply_nms_all(all_boxes, thresh: float, device='cuda'):
    """NMS per class and image over all_boxes[class][image] (N, 5) dets
    (ref lib/model/test.py:135-163 apply_nms) through `nms_function`:
    degenerate boxes dropped first, the kept rows copied in greedy
    order."""
    nms_fn = nms_function(device)
    out = [[[] for _ in r] for r in all_boxes]
    for c, per_image in enumerate(all_boxes):
        for i, dets in enumerate(per_image):
            dets = np.asarray(dets)
            if dets.size == 0:
                continue
            ok = (dets[:, 2] > dets[:, 0]) & (dets[:, 3] > dets[:, 1])
            dets = dets[ok]
            if dets.size == 0:
                continue
            out[c][i] = dets[nms_fn(dets, thresh)].copy()
    return out


def main(argv=None):
    """Runs the evaluation; returns the APs."""
    args = parse_args(argv)
    from tpudenoise_torch.cli.test import resolve_device
    from tpudenoise_torch.core.config import cfg
    from tpudenoise_torch.data.factory import get_imdb

    device = resolve_device(args.device)
    det_file = osp.join(args.output_dir, 'detections.pkl')
    with open(det_file, 'rb') as f:
        all_boxes = pickle.load(f)
    imdb_obj = get_imdb(args.imdb_name)
    imdb_obj.competition_mode(args.comp_mode)
    if args.apply_nms:
        print(f'Applying NMS to all detections (thresh {cfg.TEST.NMS})')
        all_boxes = apply_nms_all(all_boxes, cfg.TEST.NMS, device)
    print(f'Evaluating detections from {det_file}')
    return imdb_obj.evaluate_detections(all_boxes, args.output_dir)


if __name__ == '__main__':
    main()
