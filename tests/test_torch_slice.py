"""The whole eval slice: the port's test_net_batched against the JAX
package's on the same fixture dataset and weights, both models in f32 and
both noise pipelines on the counter-hash kernels (the JAX side runs its
Pallas kernels in interpret mode).

Tolerance: the two sides agree to ~1e-5 through the detector (see
test_torch_detector.py), but a marginal score or NMS keep can flip on a
random-init net, so the check is aggregate, as the reference's own
batched-eval parity test is: every JAX detection has a port twin within
0.5 px (and score) in >= 95% of cases, and the count per (class, image)
differs by at most one.

The mixed plan adds the quant palette (k-means centres within a few ulps
of the reference's, so a near-tie pixel can map to another colour) and
brownian's other summation order; both stay far inside that bound.

Also: the port imports neither jax nor flax (checked in a subprocess where
both are blocked, running all four noise plans), and its only tpudenoise
imports are the four jax-free modules."""

import functools
import os
import os.path as osp
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    root = tmp_path_factory.mktemp('tslice')
    make_rrdata_fixture(root, n_test=5, size=(160, 200))
    jc, tc = jax_default_config(), default_config()
    jc.DATA_DIR = str(root)
    for c in (jc, tc):
        c.ROOT_DIR = str(root)
        c.TEST.SCALES = (150,)
        c.TEST.MAX_SIZE = 200
        c.TEST.RPN_PRE_NMS_TOP_N = 256
        c.TEST.RPN_POST_NMS_TOP_N = 64
    return jc, tc


@pytest.mark.parametrize('noise', ['sap_median_var0.4',
                                   'gaussian_gaus_blur_var0.1',
                                   'noise_mix_var_medium', 'bloom'])
def test_slice_matches_jax(env, noise, monkeypatch):
    import jax
    import jax.numpy as jnp
    import tpudenoise.eval.harness as jharness
    import tpudenoise.noise.pallas_bloom as pb
    import tpudenoise.noise.pallas_kernels as pk
    import tpudenoise.noise.pallas_mix as pm
    from tpudenoise.data.voc_like import rrData
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
    from tpudenoise_torch.eval.harness import test_net_batched
    from tpudenoise_torch.models.convert import from_jax_params
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    import torch
    jc, tc = env
    jax.config.update('jax_threefry_partitionable', True)
    for name in ('fused_sap_median_batched', 'fused_gaussian_blur'):
        monkeypatch.setattr(pk, name, functools.partial(
            getattr(pk, name), interpret=True))
    monkeypatch.setattr(pb, 'bloom_pallas', functools.partial(
        pb.bloom_pallas, interpret=True))
    # the mix pipeline passes its own interpret flag: force the keyword
    fn = pm.fused_mix_noise
    monkeypatch.setattr(pm, 'fused_mix_noise', lambda *a, **k: fn(
        *a, **{**k, 'interpret': True}))
    monkeypatch.setattr(jharness, 'make_pipeline', functools.partial(
        jax_make_pipeline, use_pallas=True))

    jm = JRCNN(backbone='vgg16', num_classes=2, cfg=jc, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0), image_shape=(160, 224))
    tm = FasterRCNN('vgg16', num_classes=2, cfg=tc, dtype=torch.float32)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))

    tag = noise
    d1 = rrData('test', '2021', config=jc)
    d1.competition_mode(True)
    jharness.test_net_batched(jm, jp, d1, 'jax_' + tag, noise, eval_batch=3,
                              config=jc, bucket=(160, 224), mesh=None)
    d2 = rrData('test', '2021', config=jc)
    d2.competition_mode(True)
    test_net_batched(tm, params, d2, 'torch_' + tag, noise, eval_batch=3,
                     config=tc, bucket=(160, 224))

    def load(name):
        path = osp.join(jc.ROOT_DIR, 'output', jc.EXP_DIR, d1.name, name,
                        'detections.pkl')
        with open(path, 'rb') as f:
            return pickle.load(f)

    want, got = load('jax_' + tag), load('torch_' + tag)
    assert len(want) == len(got) == 2
    matched = total = 0
    for cls in range(2):
        for i in range(len(want[cls])):
            a, b = np.asarray(want[cls][i]), np.asarray(got[cls][i])
            assert abs(len(a) - len(b)) <= 1, (cls, i, len(a), len(b))
            for row in a.reshape(-1, 5):
                total += 1
                if b.size and np.abs(b - row).max(1).min() < 0.5:
                    matched += 1
    print(f'{noise}: {matched}/{total} JAX detections matched')
    assert total > 0 and matched / total >= 0.95, (matched, total)


def test_port_imports_no_jax_and_runs_detect_chunk():
    code = textwrap.dedent('''
        import sys
        sys.modules['jax'] = None
        sys.modules['flax'] = None
        import numpy as np
        import torch
        import tpudenoise_torch
        from tpudenoise_torch.core import prng
        from tpudenoise_torch.core.config import default_config
        from tpudenoise_torch.eval import harness
        from tpudenoise_torch.models import convert
        from tpudenoise_torch.models.faster_rcnn import FasterRCNN
        from tpudenoise_torch.noise.pipeline import make_pipeline
        cfg = default_config()
        cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 128, 32
        model = FasterRCNN('vgg16', num_classes=3, cfg=cfg)
        params = model.init(torch.Generator().manual_seed(0))
        raw = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (2, 40, 56, 3)).astype(np.uint8))
        geom = torch.tensor([[40, 56, 40, 56, 1.0]] * 2)
        for noise in ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
                      'noise_mix_var_medium', 'bloom'):
            boxes, scores, mask = harness.detect_chunk(
                model, params, prng.PRNGKey(3), [0, 1], raw, geom,
                geom[:, 2:], make_pipeline(noise), (48, 64))
            assert boxes.shape == (2, 2, 100, 4), boxes.shape
            assert torch.isfinite(boxes).all()
        loaded = sorted(m for m in sys.modules
                        if m == 'tpudenoise' or m.startswith('tpudenoise.'))
        print(' '.join(loaded))
    ''')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, 'PYTHONPATH': REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = set(res.stdout.split())
    allowed = {'tpudenoise', 'tpudenoise.noise', 'tpudenoise.noise.spec',
               'tpudenoise.utils', 'tpudenoise.utils.blob',
               'tpudenoise.models', 'tpudenoise.models.convert',
               'tpudenoise.eval', 'tpudenoise.eval.voc_eval'}
    assert loaded <= allowed, loaded - allowed
