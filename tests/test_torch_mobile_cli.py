"""`cli.test --compute-id`, `cli.demo` and `cli.trainval` with `--net
mobile`, the port's beside the JAX package's, on the CPU.

One `.npz` of weights for both: the port's seeded full-width mobile of
two classes (flax's lecun-normal kernels, as the JAX init) with its BN
statistics randomized (the seeded BN is the identity), written by the
JAX package's `save_params_npz`.  Both detectors run in f32 and the JAX
noise on its Pallas kernels in interpret mode (`cli_env` of
tests/test_torch_cli.py); the tolerance is that file's: >= 95% of the
JAX detections with a port twin within 0.5 (px and score), counts per
(class, image) within one.  --compute-id: the pooled probe features that
each CLI hands its TwoNN estimator within 1e-5 of their largest
magnitude (tests/test_torch_twonn.py's bound; measured 4e-7), and each
logged ID finite, positive and the port's estimator on those features.
The IDs are not compared across packages here (tests/test_torch_twonn.py
holds the estimator on well-conditioned points): with 10 images whose
nearest distances at the deep probes are 0.4-0.6% of the features'
norms, the estimate is ill-conditioned (measured: the port's features,
2e-7 from JAX's, move 'head' from 26.4 to 30.5 in the JAX estimator, 1e-5
of random noise to 33.8, and the two estimators' distance sums (x.x^T,
other orders) read 29.76 and 30.50 on the same features).  The training
step: finite losses, the frozen layers bit-equal to the loaded weights,
others moved."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_cli import PHOTO, SMALL, _match, cli_env  # noqa: F401
from tests.test_torch_resnet import _randomize
from tpudenoise_torch.models import convert
from tpudenoise_torch.models.faster_rcnn import FasterRCNN

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope='module')
def mobile_env(tmp_path_factory):
    """The fixture dataset (10 test, 2 trainval images of 120x160) and
    the weights as `.npz`."""
    from tests.fixtures import make_rrdata_fixture
    from tpudenoise.models.convert import save_params_npz as j_save
    root = tmp_path_factory.mktemp('mobile_cli')
    make_rrdata_fixture(str(root), n_train=2, n_test=10, size=(120, 160))
    model = FasterRCNN('mobile', num_classes=2)
    tree = _randomize(convert._unflatten(convert.to_jax_flat(model.init(
        torch.Generator().manual_seed(0)))), np.random.RandomState(1))
    npz = osp.join(str(root), 'mobile.npz')
    j_save(tree, npz)
    return str(root), npz


class _Recorder:
    active_sinks = False

    def __init__(self):
        self.logged = {}

    def log(self, metrics, step=None):
        self.logged.update(metrics)


def test_cli_test_mobile_compute_id_matches_jax(mobile_env, cli_env,
                                                monkeypatch):
    import tpudenoise.analysis.twonn as jt
    import tpudenoise_torch.analysis.twonn as tt
    from tpudenoise.cli import test as jtest
    from tpudenoise_torch.cli import test as ttest
    from tpudenoise_torch.eval import harness as tharness
    root, npz = mobile_env
    trec = _Recorder()
    monkeypatch.setattr(tharness, 'get_metrics_logger', lambda: trec)
    feats = {}
    for mod in (jt, tt):
        def spy(f, *a, real=mod.per_layer_id, tag=mod.__name__, **k):
            feats[tag] = {p: np.asarray(v) for p, v in f.items()}
            return real(f, *a, **k)
        monkeypatch.setattr(mod, 'per_layer_id', spy)
    common = ['--net', 'mobile', '--imdb', 'rrData_2021_test', '--noise',
              'sap_median_var0.4', '--eval-batch', '5', '--model', npz,
              '--compute-id', '--cfg',
              osp.join(REPO, 'experiments', 'cfgs', 'mobile.yml')]
    sets = ['DATA_DIR', root, 'ROOT_DIR', root, 'TEST.SCALES', '[120]',
            'TEST.MAX_SIZE', '160'] + SMALL
    jtest.main(common + ['--set'] + sets + ['EXP_DIR', 'jax'])
    aps = ttest.main(common + ['--device', 'cpu', '--set'] + sets
                     + ['EXP_DIR', 'torch'])

    def load(exp):
        path = osp.join(root, 'output', exp, 'rrData_2021_test',
                        npz.replace('/', '_'), 'detections.pkl')
        with open(path, 'rb') as f:
            return pickle.load(f)

    want, got = load('jax'), load('torch')
    assert len(aps) == 10 and np.isfinite(aps).all()
    matched, total, _ = _match(want[1], got[1])
    assert total > 0 and matched / total >= 0.95, (matched, total)
    want, got = feats[jt.__name__], feats[tt.__name__]
    assert sorted(got) == sorted(want) == sorted(tt.PROBES['mobile']
                                                 + ['head'])
    for p, w in want.items():
        assert got[p].shape == w.shape == (10, w.shape[1]), p
        assert np.abs(got[p] - w).max() <= 1e-5 * np.abs(w).max(), p
        mean_id, err_id = tt.compute_id(got[p], nres=10)
        logged = trec.logged[f'twonn_id/{p}']
        assert np.isfinite(logged) and logged > 0, p
        assert (logged, trec.logged[f'twonn_id_err/{p}']) == (mean_id,
                                                              err_id), p


def test_cli_demo_mobile_matches_jax(mobile_env, cli_env, tmp_path,
                                     monkeypatch):
    import tpudenoise.core.config as jconfig
    import tpudenoise.eval.harness as jharness
    import tpudenoise_torch.core.config as tconfig
    from tpudenoise.cli import demo as jdemo
    from tpudenoise_torch.cli import demo as tdemo
    _, npz = mobile_env
    for c in (jconfig.cfg, tconfig.cfg):
        c.TEST.RPN_PRE_NMS_TOP_N, c.TEST.RPN_POST_NMS_TOP_N = 256, 64
    seen = []
    post = jharness.postprocess_detections
    monkeypatch.setattr(jharness, 'postprocess_detections', lambda *a, **k:
                        seen.append([np.asarray(x) for x in post(*a, **k)])
                        or seen[-1])
    args = ['--net', 'mobile', '--noise', 'gaussian_gaus_blur_var0.1',
            '--classes', '__background__', 'person', '--images', PHOTO,
            '--conf', '0.0', '--model', npz]
    jdemo.main(args + ['--out', str(tmp_path / 'jax.png')])
    res = tdemo.main(args + ['--out', str(tmp_path / 'sheet.ppm'),
                             '--device', 'cpu'])

    def dets(boxes, scores, mask):
        return [np.hstack([boxes[0][mask[0]], scores[0][mask[0]][:, None]])]

    (img,) = res['images']
    matched, total, _ = _match(dets(*seen[0]), dets(img['boxes'],
                                                    img['scores'],
                                                    img['mask']))
    assert total > 0 and matched / total >= 0.95, (matched, total)
    assert tdemo.read_ppm(res['out']).shape == (375, 500, 3)


def test_cli_trainval_mobile_step(mobile_env, cli_env, monkeypatch):
    """One `cli.trainval --net mobile --device cpu` iteration from the
    `.npz` (`--weight`): finite losses; every parameter that
    frozen_param_filter freezes (the first FIXED_LAYERS layers) bit-equal
    to the loaded weights, others moved."""
    from tpudenoise_torch.cli import trainval
    from tpudenoise_torch.train import solver as solver_mod
    root, npz = mobile_env
    inits = []
    real = solver_mod.make_train_step

    def spy(model, cfg, **kw):
        init, step = real(model, cfg, **kw)

        def init_state(*a):
            st = init(*a)
            inits.append((model, {k: v.clone() for k, v in
                                  st.params.items()}))
            return st
        return init_state, step

    monkeypatch.setattr(solver_mod, 'make_train_step', spy)
    state = trainval.main([
        '--device', 'cpu', '--net', 'mobile', '--imdb',
        'rrData_2021_trainval', '--imdbval', 'rrData_2021_trainval',
        '--iters', '1', '--noise', 'sap_median_var0.4', '--tag', 't',
        '--weight', npz, '--set', 'DATA_DIR', root, 'ROOT_DIR', root,
        'TRAIN.SCALES', '[120]', 'TRAIN.MAX_SIZE', '160',
        'TRAIN.RPN_PRE_NMS_TOP_N', '128', 'TRAIN.RPN_POST_NMS_TOP_N', '32',
        'TRAIN.BATCH_SIZE', '8', 'TRAIN.DISPLAY', '1'])
    assert state.step == 1
    (model, init), = inits
    # the solver merges the .npz over the seeded init: every entry
    before = convert.merge_pretrained(init, convert.load_params_npz(npz))
    names = [n for n, _ in model.named_parameters()]
    frozen = [n for n in names if model.frozen(n)]
    assert 'head.layer_4.pointwise.weight' in frozen
    for n in frozen:
        assert torch.equal(state.params[n], before[n]), n
    assert not torch.equal(state.params['head.layer_5.pointwise.weight'],
                           before['head.layer_5.pointwise.weight'])
