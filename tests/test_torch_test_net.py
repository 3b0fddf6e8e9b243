"""The port's `test_net` (the one-image loop) against the JAX package's
`test_net` and against the port's own `test_net_batched`, on the CPU.

* At scale 1 (the 120x160 fixture, TEST scale 120, MAX_SIZE 160) the
  JAX package's host prep (cv2) and the port's device prep are exact, so
  the loops differ only by the detector's float order: the tolerance of
  `tests/test_torch_slice.py` (>= 95% of the JAX detections with a port
  twin within 0.5, counts within one), for a single-kind and a mix
  string.
* On a dataset of several shapes (noise buckets, each image's noise
  cropped back to its raw size) under a two-scale pyramid, `test_net`
  and `test_net_batched` run the same noise, prep and postprocess, one
  image a forward against four: the same tolerance, and the APs within
  it.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from tests.fixtures import make_rrdata_fixture
from tests.test_torch_buckets import SIZES, cached_rrdata
from tests.test_torch_slice import match_row


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    root = str(tmp_path_factory.mktemp('ttestnet'))
    make_rrdata_fixture(root, n_test=3, size=(120, 160))
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = c.ROOT_DIR = root
        c.EXP_DIR = 'test_net'
        c.TEST.SCALES = (120,)
        c.TEST.MAX_SIZE = 160
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 32
    return jc, tc


@pytest.mark.parametrize('noise', ['sap_median_var0.4',
                                   'noise_mix_var_medium'])
def test_test_net_matches_jax_at_scale_1(env, noise, monkeypatch):
    matched, total = match_row(env, noise, monkeypatch, bucket=(128, 160),
                               loop='test_net')
    assert total > 0 and matched / total >= 0.95, (matched, total)


def test_test_net_matches_test_net_batched(tmp_path):
    """Shape-diverse images, TEST.SCALES (48, 64): test_net against
    test_net_batched (eval batch 4) with the same weights."""
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    root = str(tmp_path)
    make_rrdata_fixture(root, n_test=4, sizes=SIZES[:4])
    tc = default_config()
    tc.DATA_DIR = tc.ROOT_DIR = root
    tc.TEST.SCALES = (48, 64)
    tc.TEST.MAX_SIZE = 96
    tc.TEST.RPN_PRE_NMS_TOP_N = 128
    tc.TEST.RPN_POST_NMS_TOP_N = 32
    m = FasterRCNN('vgg16', num_classes=2, cfg=tc, dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    dets, aps = {}, {}
    for loop, kw in (('test_net', {}),
                     ('test_net_batched', {'eval_batch': 4})):
        d = cached_rrdata(tc)
        d.competition_mode(True)
        aps[loop] = getattr(harness, loop)(m, params, d, loop,
                                           'noise_mix_var_medium',
                                           config=tc, **kw)
        with open(osp.join(root, 'output', tc.EXP_DIR, d.name, loop,
                           'detections.pkl'), 'rb') as f:
            dets[loop] = pickle.load(f)
    matched = total = 0
    for a, b in zip(dets['test_net'][1], dets['test_net_batched'][1]):
        assert abs(len(a) - len(b)) <= 1
        for row in np.asarray(a).reshape(-1, 5):
            total += 1
            matched += bool(len(b) and np.abs(b - row).max(1).min() < 0.5)
    print(f'{matched}/{total} test_net detections matched')
    assert total > 0 and matched / total >= 0.95, (matched, total)
    assert len(aps['test_net']) == 10 and np.isfinite(aps['test_net']).all()
    np.testing.assert_allclose(aps['test_net'], aps['test_net_batched'],
                               atol=0.05)


def test_test_net_refuses_what_is_not_ported(tmp_path, monkeypatch,
                                             capsys):
    """compute_id and fast_rng run: test_net over 10 numpy images with both
    (their parity with the JAX package: tests/test_torch_twonn.py,
    tests/test_torch_fast_rng.py) builds the counter-hash route and logs
    a finite, positive TwoNN ID per probe.  The mesh and host prep, which
    this test once held to raise, run too: test_net_batched over the same
    images with mesh=None, with the one-rank mesh of a process group of
    one (gloo, a file rendezvous), and with device_prep=False (host prep;
    at scale 1 cv2's resize is the identity, as the device prep is):
    the same detections.pkl, bit for bit (the world of two:
    tests/test_torch_dp_eval.py; host prep against the JAX package:
    tests/test_torch_host_prep.py)."""
    import pickle

    import torch.distributed as dist

    from tpudenoise_torch.analysis.twonn import PROBES
    from tpudenoise_torch.core import mesh as M
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.eval.harness import test_net, test_net_batched
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tests.test_torch_twonn import _Imdb, _Recorder, randomize_head
    cfg = default_config()
    cfg.EXP_DIR, cfg.ROOT_DIR = 'refuse', str(tmp_path)
    cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (32,), 48
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 64, 8
    model = FasterRCNN('res50', num_classes=2, cfg=cfg, dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    randomize_head(model)           # the seeded init's conv3 is zero
    params = model.state_dict()
    paths = []
    for i, im in enumerate(np.random.RandomState(0).randint(
            0, 256, (10, 32, 48, 3)).astype(np.uint8)):
        paths.append(str(tmp_path / f'{i}.npy'))
        np.save(paths[-1], im)
    rec = _Recorder()
    monkeypatch.setattr(harness, 'get_metrics_logger', lambda: rec)
    test_net(model, params, _Imdb(paths), 'w', 'poisson', config=cfg,
             compute_id=True, fast_rng=True)
    assert 'backend: cuda:generic+fast_rng' in capsys.readouterr().out
    ids = [rec.logged[f'twonn_id/{p}'] for p in PROBES['res50'] + ['head']]
    assert np.all(np.isfinite(ids)) and min(ids) > 0

    def dets(name, **kw):
        test_net_batched(model, params, _Imdb(paths), name,
                         'sap_median_var0.4', eval_batch=4, config=cfg,
                         **kw)
        path = os.path.join(tmp_path, 'output', 'refuse', _Imdb(paths).name,
                            name, 'detections.pkl')
        with open(path, 'rb') as f:
            return pickle.load(f)

    want = dets('one', mesh=None)
    M.initialize_distributed(None, 1, 0, device='cpu',
                             init_method='file://' + str(tmp_path / 'rdv'))
    try:
        got = {'mesh': dets('mesh', mesh=M.make_mesh())}
    finally:
        dist.destroy_process_group()
    got['host'] = dets('host', mesh=None, device_prep=False)
    for g in got.values():
        for a, b in zip(want[1], g[1]):
            np.testing.assert_array_equal(a, b)
