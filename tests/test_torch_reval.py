"""The port's re-evaluation CLI (`tpudenoise_torch/cli/reval.py`) and its
host-facing NMS (`ops/nms.nms_dets`) against the JAX package's, on the
CPU.

* `apply_nms_all` on the CPU (the port's `cfg.USE_NATIVE_NMS` left set:
  its host C++ NMS) equals JAX's with its numpy oracle `nms_py` row for
  row, on dets without tied scores, degenerate boxes and empty lists
  included (both flag values: `tests/test_torch_native.py`);
* on tied scores `nms_dets` takes the tied boxes in input order (a
  stable sort), where `nms_py`'s `argsort()[::-1]` takes them in the
  order numpy's sort leaves: held against a greedy NMS over the stable
  order;
* `main` returns, with and without `--nms`, the same ten APs as the JAX
  CLI on the same detections.pkl, each fixture written by its own
  package (same XML, checked in `test_torch_noise_grid.py`).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os.path as osp
import pickle

import numpy as np
import pytest

from tpudenoise.ops.nms import nms_py
from tpudenoise_torch.ops.nms import nms_dets

N_TEST = 4


def _dets(rng, n, ties=False):
    xy = rng.rand(n, 2) * 200
    wh = rng.rand(n, 2) * 80 + 2
    scores = (rng.randint(0, 4, (n, 1)) / 4.0 if ties
              else rng.permutation(n)[:, None] / n + 0.01)
    return np.hstack([xy, xy + wh, scores]).astype(np.float32)


def _all_boxes(seed, ties=False):
    rng = np.random.RandomState(seed)
    out = [[np.zeros((0, 5), np.float32)] * N_TEST]
    per = []
    for i in range(N_TEST):
        d = _dets(rng, [0, 1, 37, 120][i], ties)
        if len(d) > 5:
            d[3, 2] = d[3, 0]                    # degenerate: x2 == x1
            d[4, 3] = d[4, 1] - 1                # degenerate: y2 < y1
        per.append(d)
    out.append(per)
    return out


@pytest.mark.parametrize('thresh', [0.3, 0.5, 0.7])
def test_nms_dets_matches_nms_py_without_ties(thresh):
    rng = np.random.RandomState(int(thresh * 10))
    for n in (1, 2, 17, 200, 700):
        d = _dets(rng, n)
        assert nms_dets(d, thresh, 'cpu') == nms_py(d, thresh), n


def test_nms_dets_on_ties_takes_input_order():
    def greedy_stable(d, t):
        x1, y1, x2, y2, s = d.T
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        keep, alive = [], np.ones(len(d), bool)
        for i in np.argsort(-s, kind='stable'):
            if not alive[i]:
                continue
            keep.append(int(i))
            w = np.maximum(0, np.minimum(x2[i], x2) - np.maximum(x1[i], x1)
                           + 1)
            h = np.maximum(0, np.minimum(y2[i], y2) - np.maximum(y1[i], y1)
                           + 1)
            inter = w * h
            alive &= ~(inter / (areas[i] + areas - inter) > np.float32(.3))
        return keep
    rng = np.random.RandomState(5)
    for n in (8, 64, 300):
        d = _dets(rng, n, ties=True)
        assert nms_dets(d, 0.3, 'cpu') == greedy_stable(d, 0.3)


def test_apply_nms_all_matches_jax(monkeypatch):
    from tpudenoise.cli.reval import apply_nms_all as j_apply
    from tpudenoise.core.config import cfg as jcfg
    from tpudenoise_torch.cli.reval import apply_nms_all
    monkeypatch.setattr(jcfg, 'USE_NATIVE_NMS', False)
    boxes = _all_boxes(0)
    want, got = j_apply(boxes, 0.3), apply_nms_all(boxes, 0.3, 'cpu')
    for c in range(2):
        for i in range(N_TEST):
            a, b = np.asarray(want[c][i]), np.asarray(got[c][i])
            assert a.shape == b.shape, (c, i)
            np.testing.assert_array_equal(a, b)
    assert sum(len(x) for x in got[1]) > 0


@pytest.mark.parametrize('nms', [False, True])
def test_reval_aps_match_jax(tmp_path, monkeypatch, nms):
    import tpudenoise.data.voc_like as jvoc
    from tests.fixtures import make_rrdata_fixture
    from tpudenoise.cli import reval as jreval
    from tpudenoise.core.config import cfg as jcfg
    from tpudenoise_torch.cli import reval
    from tpudenoise_torch.core.config import cfg
    from tpudenoise_torch.data.synthetic import write_rrdata_fixture
    jroot, troot = tmp_path / 'jax', tmp_path / 'torch'
    make_rrdata_fixture(str(jroot), n_train=1, n_test=N_TEST, seed=3)
    gt = write_rrdata_fixture(str(troot), n_train=1, n_test=N_TEST, seed=3)
    monkeypatch.setattr(jcfg, 'DATA_DIR', str(jroot))
    monkeypatch.setattr(jcfg, 'USE_NATIVE_NMS', False)
    monkeypatch.setattr(cfg, 'DATA_DIR', str(troot))
    monkeypatch.setattr(cfg, 'ROOT_DIR', str(troot))
    # detections near the ground truth (jittered, with duplicates for
    # --nms to remove) plus random ones, scores without ties
    rng = np.random.RandomState(7)
    boxes = [[np.zeros((0, 5), np.float32)] * N_TEST, []]
    for i in range(N_TEST):
        g = np.asarray(gt[f'te{i:03d}'], np.float32)
        near = np.repeat(g, 3, 0) + rng.randn(3 * len(g), 4) * 6
        d = np.vstack([near, _dets(rng, 12)[:, :4]])
        s = rng.permutation(len(d))[:, None] / len(d) + 0.01
        boxes[1].append(np.hstack([d, s]).astype(np.float32))
    out = {}
    for name, root in (('jax', jroot), ('torch', troot)):
        od = tmp_path / ('out_' + name)
        od.mkdir()
        with open(od / 'detections.pkl', 'wb') as f:
            pickle.dump(boxes, f)
        out[name] = str(od)
    argv = ['--imdb', 'rrData_2021_test', '--comp'] + (['--nms'] if nms
                                                      else [])
    seen = []
    orig = jvoc.VocStyleDataset.evaluate_detections
    monkeypatch.setattr(jvoc.VocStyleDataset, 'evaluate_detections',
                        lambda self, b, d: seen.append(orig(self, b, d))
                        or seen[-1])
    jreval.main([out['jax']] + argv)
    got = reval.main([out['torch']] + argv + ['--device', 'cpu'])
    assert len(seen) == 1 and len(got) == 10
    np.testing.assert_array_equal(np.asarray(got), np.asarray(seen[0]))
    assert 0 < got[0] < 1 and all(np.isfinite(got))
    assert osp.exists(osp.join(out['torch'], 'person_pr.pkl'))
