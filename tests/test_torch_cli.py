"""The port's CLIs against the JAX package's, on one `.npz` of weights.

`tpudenoise_torch.cli.test.main` runs beside `tpudenoise.cli.test.main`
(`--eval-batch 1`: JAX's test_net; `--eval-batch 3`: its
test_net_batched) on the 120x160 fixture at scale 1, and
`tpudenoise_torch.cli.demo.main` beside `tpudenoise.cli.demo.main` on
`data/demo/000456.jpg` (375x500, scale 1.6, so the port's device prep
interpolates).  The weights are JAX's vgg16 init, written by JAX's
`save_params_npz`: a torch generator would give other weights.

Both CLIs build `FasterRCNN` in bf16, where XLA and torch break ties
differently on the CPU; here both are patched to f32, as
`test_torch_slice.py` builds them.  Tolerance as there: >= 95% of the
JAX detections have a port twin within 0.5 (px and score), and the
counts per (class, image) differ by at most one; where every detection
is equal (1e-3), the APs must be equal too.  The JAX side runs its Pallas
noise kernels in interpret mode.

Both CLIs keep a module-level config; each test restores both.  The
other checks: without CUDA, `--device cuda` (the default) exits non-zero
naming the GPU; `_log_det_scores` writes the events of
`tests/test_logging.py::test_eval_det_score_summaries`; `get_imdb` knows
the JAX package's names and builds VOC and COCO sets as it does.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import copy
import functools
import os
import os.path as osp
import pickle
import subprocess
import sys

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PHOTO = osp.join(REPO, 'data', 'demo', '000456.jpg')
SMALL = ['TEST.RPN_PRE_NMS_TOP_N', '256', 'TEST.RPN_POST_NMS_TOP_N', '64']


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    """The fixture dataset and JAX's vgg16 init (two classes) as .npz."""
    import jax
    import jax.numpy as jnp
    from tpudenoise.models.convert import save_params_npz
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    root = tmp_path_factory.mktemp('tcli')
    make_rrdata_fixture(str(root), n_test=3, size=(120, 160))
    jm = JRCNN(backbone='vgg16', num_classes=2, dtype=jnp.float32)
    npz = str(root / 'vgg16.npz')
    save_params_npz(jax.jit(lambda k: jm.init(k, image_shape=(64, 96)))(
        jax.random.PRNGKey(0)), npz)
    return str(root), npz


@pytest.fixture
def cli_env(monkeypatch):
    """Both packages' module-level cfg restored after the test, both
    detectors in f32, and the JAX side's noise on its Pallas kernels in
    interpret mode (the port's kernels' counterparts)."""
    import jax
    import jax.numpy as jnp
    import torch
    import tpudenoise.core.config as jconfig
    import tpudenoise.eval.harness as jharness
    import tpudenoise.models.faster_rcnn as jfr
    import tpudenoise.noise.pallas_kernels as pk
    import tpudenoise.noise.pipeline as jpipeline
    import tpudenoise_torch.core.config as tconfig
    import tpudenoise_torch.models.faster_rcnn as tfr
    saved = [(mod.cfg, copy.deepcopy(mod.cfg)) for mod in (jconfig, tconfig)]
    jax.config.update('jax_threefry_partitionable', True)
    for name in ('fused_sap_median_batched', 'fused_gaussian_blur',
                 'fused_sap_median'):
        monkeypatch.setattr(pk, name, functools.partial(
            getattr(pk, name), interpret=True))
    pallas = functools.partial(jpipeline.make_pipeline, use_pallas=True)
    monkeypatch.setattr(jharness, 'make_pipeline', pallas)
    monkeypatch.setattr(jpipeline, 'make_pipeline', pallas)
    monkeypatch.setattr(jfr, 'FasterRCNN', functools.partial(
        jfr.FasterRCNN, dtype=jnp.float32))
    monkeypatch.setattr(tfr, 'FasterRCNN', functools.partial(
        tfr.FasterRCNN, dtype=torch.float32))
    yield
    for live, copy_ in saved:
        live.clear()
        live.update(copy_)


def _match(want, got):
    """(matched, total, all_equal) of JAX detections `want` against the
    port's `got`, lists per (class, image) of (K, 5) rows."""
    matched = total = 0
    equal = True
    for a, b in zip(want, got):
        a, b = np.asarray(a).reshape(-1, 5), np.asarray(b).reshape(-1, 5)
        assert abs(len(a) - len(b)) <= 1, (len(a), len(b))
        equal &= a.shape == b.shape and (
            a.size == 0 or np.abs(a - b).max() < 1e-3)
        for row in a:
            total += 1
            matched += bool(b.size and np.abs(b - row).max(1).min() < 0.5)
    return matched, total, equal


@pytest.mark.parametrize('eval_batch', [1, 3])
def test_cli_test_matches_jax(env, cli_env, eval_batch, monkeypatch):
    from tpudenoise.cli import test as jtest
    from tpudenoise.data.voc_like import VocStyleDataset
    from tpudenoise_torch.cli import test as ttest
    root, npz = env
    jax_aps = []
    evaluate = VocStyleDataset.evaluate_detections
    monkeypatch.setattr(VocStyleDataset, 'evaluate_detections',
                        lambda self, *a: jax_aps.append(evaluate(self, *a))
                        or jax_aps[-1])
    common = ['--net', 'vgg16', '--imdb', 'rrData_2021_test', '--noise',
              'sap_median_var0.4', '--eval-batch', str(eval_batch),
              '--model', npz, '--cfg',
              osp.join(REPO, 'experiments', 'cfgs', 'vgg16.yml')]
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
    assert len(want) == len(got) == 2 and len(aps) == 10
    matched, total, equal = _match(want[1], got[1])
    print(f'eval batch {eval_batch}: {matched}/{total} JAX detections '
          f'matched; all equal: {equal}')
    assert total > 0 and matched / total >= 0.95, (matched, total)
    if equal:
        np.testing.assert_allclose(aps, jax_aps[0], rtol=0, atol=1e-12)


def test_cli_demo_matches_jax(env, cli_env, tmp_path, monkeypatch):
    import tpudenoise.core.config as jconfig
    import tpudenoise.eval.harness as jharness
    import tpudenoise_torch.core.config as tconfig
    from tpudenoise.cli import demo as jdemo
    from tpudenoise_torch.cli import demo as tdemo
    _, npz = env
    for c in (jconfig.cfg, tconfig.cfg):
        c.TEST.RPN_PRE_NMS_TOP_N, c.TEST.RPN_POST_NMS_TOP_N = 256, 64
    seen = []
    post = jharness.postprocess_detections
    monkeypatch.setattr(jharness, 'postprocess_detections', lambda *a, **k:
                        seen.append([np.asarray(x) for x in post(*a, **k)])
                        or seen[-1])
    args = ['--net', 'vgg16', '--noise', 'gaussian_gaus_blur_var0.1',
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
    print(f'demo: {matched}/{total} JAX detections matched')
    assert total > 0 and matched / total >= 0.95, (matched, total)
    sheet = tdemo.read_ppm(res['out'])
    assert sheet.shape == (375, 500, 3) == res['sheet_shape']
    # the sheet holds the drawn boxes: pure red where a box's edge runs
    assert (sheet == (0, 0, 255)).all(-1).sum() > 0


def test_cli_refuses_without_a_gpu():
    """No --device: the default cuda, and torch sees no GPU here."""
    res = subprocess.run([sys.executable, '-m', 'tpudenoise_torch.cli.test',
                          '--net', 'vgg16'], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, 'PYTHONPATH': REPO,
                              'CUDA_VISIBLE_DEVICES': ''})
    assert res.returncode != 0
    assert 'GPU' in res.stderr, res.stderr[-2000:]


def test_det_score_summaries(tmp_path):
    """As tests/test_logging.py::test_eval_det_score_summaries: one
    'score' scalar per >= 0.8 detection, stepped by image index."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    from tpudenoise_torch.eval.harness import _log_det_scores
    from tpudenoise_torch.utils.logging import (MetricsLogger,
                                                get_metrics_logger,
                                                set_metrics_logger)
    prev = get_metrics_logger()
    logger = MetricsLogger(tb_dir=str(tmp_path), quiet=True)
    set_metrics_logger(logger)
    try:
        dets = np.asarray([[0, 0, 10, 10, 0.95],
                           [1, 1, 8, 9, 0.5],
                           [2, 2, 9, 9, 0.81]], np.float32)
        _log_det_scores(dets, image_index=4)
        _log_det_scores(np.zeros((0, 5), np.float32), image_index=5)
    finally:
        set_metrics_logger(prev)
    logger.close()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    sc = acc.Scalars('score')
    assert len(sc) == 2
    assert {round(s.value, 2) for s in sc} == {0.95, 0.81}
    assert all(s.step == 4 for s in sc)


def test_get_imdb_names_match_jax(tmp_path, monkeypatch):
    """The same names, and voc_2007_test and coco_2014_minival build on a
    numpy-written fixture as the JAX package's do (classes, images,
    roidb), on their cached pixels when every image has one."""
    import tpudenoise.core.config as jconfig
    from tpudenoise.data.factory import get_imdb as jax_get_imdb
    from tpudenoise.data.factory import list_imdbs as jax_list_imdbs
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import synthetic
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.factory import get_imdb, list_imdbs
    assert list_imdbs() == jax_list_imdbs()
    root = str(tmp_path)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    monkeypatch.setattr(jconfig.cfg, 'DATA_DIR', root)
    shapes = [(60, 80), (80, 60), (50, 70)]
    synthetic.write_voc(root, shapes,
                        pixel_dir=default_pixel_dir('voc_2007_test', cfg))
    synthetic.write_coco(root, shapes)
    for name in ('voc_2007_test', 'coco_2014_minival'):
        d, j = get_imdb(name, cfg), jax_get_imdb(name)
        assert d.name == j.name == name
        assert list(d.classes) == list(j.classes)
        assert d.image_index == j.image_index
        for a, b in zip(d.roidb, j.roidb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert get_imdb('voc_2007_test', cfg).image_path_at(0).endswith(
        osp.join('voc_2007_test', '000000.npy'))
    assert get_imdb('coco_2014_minival', cfg).image_path_at(0).endswith(
        osp.join('images', 'val2014', 'COCO_val2014_000000000001.jpg'))
