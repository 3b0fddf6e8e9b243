"""Data-parallel evaluation in the port (`test_net_batched(mesh=...)`,
`cli.test --distributed`) on the CPU, with gloo ranks in subprocesses
(`tests/torch_ranks.py`).

`cli.test --distributed --eval-batch 4 --compute-id` over the 10-image
fixture dataset (chunks of 4, 4 and 2 padded to 4) at world 2 (each rank
reads and runs two images of a chunk) against the same command at world
1 (one process, a process group of one: no mesh): rank 0 writes the
same detections.pkl, row for row, and prints the same TwoNN intrinsic
dimensions (the probe features gathered in image order); rank 1 writes
nothing.  The model is a seeded mobile in f32 (the CLI's bf16 would
round one image's and two images' convolutions alike only by chance).
Bound: every box and score within 1e-4 (f32 convolutions of one and two
images sum in other orders), the same count per (class, image).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools
import glob
import os
import os.path as osp
import pickle

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture
from tests.torch_ranks import REPO, run_ranks

TOL = 1e-4

RANKS = r'''
import functools, os, sys
import torch
import tpudenoise_torch.models.faster_rcnn as tfr
tfr.FasterRCNN = functools.partial(tfr.FasterRCNN, dtype=torch.float32)
from tpudenoise_torch.cli import test
aps = test.main(['--dist-init-method', os.environ['TORCH_DIST_INIT']]
                + sys.argv[1:])
assert (aps is None) == (os.environ['RANK'] != '0')
assert 'jax' not in sys.modules
print('RANK_OK')
'''


def _argv(root, exp):
    return ['--distributed', '--device', 'cpu', '--net', 'mobile', '--cfg',
            osp.join(REPO, 'experiments', 'cfgs', 'mobile.yml'),
            '--imdb', 'rrData_2021_test', '--noise', 'sap_median_var0.4',
            '--eval-batch', '4', '--compute-id', '--set', 'DATA_DIR', root,
            'ROOT_DIR', root, 'EXP_DIR', exp, 'TEST.SCALES', '[120]',
            'TEST.MAX_SIZE', '160', 'TEST.RPN_PRE_NMS_TOP_N', '256',
            'TEST.RPN_POST_NMS_TOP_N', '64']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp_eval')
    make_rrdata_fixture(str(root), n_test=10, size=(120, 160))
    out = {}
    for world in (1, 2):
        outs = run_ranks(RANKS, world, root,
                         args=_argv(str(root), f'world{world}'))
        assert all('RANK_OK' in o for o in outs)
        path, = glob.glob(osp.join(str(root), 'output', f'world{world}',
                                   '*', '*', 'detections.pkl'))
        with open(path, 'rb') as f:
            out[world] = dict(dets=pickle.load(f), stdout=outs)
    return out


def test_world2_detections_equal_world1(runs):
    a, b = runs[1]['dets'], runs[2]['dets']
    assert len(a) == len(b) == 2 and len(a[1]) == len(b[1]) == 10
    n = 0
    for x, y in zip(a[1], b[1]):
        x, y = np.asarray(x).reshape(-1, 5), np.asarray(y).reshape(-1, 5)
        assert x.shape == y.shape
        if x.size:
            np.testing.assert_allclose(y, x, rtol=0, atol=TOL)
        n += len(x)
    assert n > 0


def test_world2_gathers_features_and_reports(runs):
    def ids(stdout):
        lines = stdout.splitlines()
        at = lines.index('TwoNN intrinsic dimension per probe layer:')
        return [line.split()[:2] for line in lines[at + 1:]
                if line.startswith('  ')]
    one, two = ids(runs[1]['stdout'][0]), ids(runs[2]['stdout'][0])
    assert len(one) > 1 and [p for p, _ in one] == [p for p, _ in two]
    np.testing.assert_allclose([float(v) for _, v in two],
                               [float(v) for _, v in one], atol=0.02)
    assert 'evaluating on a 2-rank mesh' in runs[2]['stdout'][1]
    assert 'TwoNN' not in runs[2]['stdout'][1]
