"""The port's solver on the CPU: a res50 trained 3 iterations, then resumed
from its snapshot to 5, equals an uninterrupted 5-iteration run bit for
bit (params, momentum, step, key and every iteration's batch, keys and
losses), with and without the prefetching loader; snapshots are pruned
to SNAPSHOT_KEPT; the padded batches take the masked noise and leave a
zero pad; a port snapshot's params written as `.npz` load in the JAX
package.  The data: `tests/fixtures.make_rrdata_fixture` images of
(120, 160), their `.npy` pixels, in a (128, 192) bucket (so every batch
is padded), noise bloom (the generic route's masked form).  The model is
res50 in f32 (a snapshot holds params and momentum: 0.2 GB for res50,
1.1 GB for vgg16; bf16 matmuls are slow on the CPU); the snapshot
directories are removed at the end."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from tests.fixtures import make_rrdata_fixture

BUCKET = (128, 192)
NOISE = 'bloom'


@pytest.fixture(scope='module')
def scratch(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_solver')
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope='module')
def env(scratch):
    root = str(scratch / 'data')
    make_rrdata_fixture(root, n_train=3, n_test=2, size=(120, 160))
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.roidb import combined_roidb
    from tpudenoise_torch.data.voc_like import rrData
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    cfg.TRAIN.SCALES, cfg.TRAIN.MAX_SIZE = (120,), 160
    cfg.TRAIN.RPN_PRE_NMS_TOP_N, cfg.TRAIN.RPN_POST_NMS_TOP_N = 256, 64
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.RPN_BATCHSIZE = 16, 32
    cfg.TRAIN.SNAPSHOT_ITERS, cfg.TRAIN.SNAPSHOT_KEPT = 2, 1
    cfg.TRAIN.DISPLAY = 1
    # no summary on the host clock's say-so: its validation step draws
    # keys, so a run slow enough to reach SUMMARY_INTERVAL (180 s) in one
    # run and not the other took other keys after it
    cfg.TRAIN.SUMMARY_INTERVAL = 10 ** 9
    cfg.TRAIN.LEARNING_RATE = 1e-4
    cfg.ANCHOR_SCALES = [2, 4, 8]
    d = rrData('train', config=cfg)
    cache_pixels.cache(d, cache_pixels.default_pixel_dir(d.name, cfg))
    imdb, roidb = combined_roidb('rrData_2021_train', NOISE, cfg)
    return cfg, imdb, roidb


def _solver(env, out, prefetch):
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.train.solver import Solver
    cfg, imdb, roidb = env
    torch.manual_seed(0)
    model = FasterRCNN('res50', num_classes=2, cfg=cfg,
                       anchor_scales=tuple(cfg.ANCHOR_SCALES),
                       dtype=torch.float32)
    return Solver(model, imdb, roidb, roidb, out, out + '_tb', noise=NOISE,
                  config=cfg, bucket=BUCKET, prefetch=prefetch,
                  device='cpu')


def _train(env, out, iters, prefetch, seen):
    def on_step(it, key, k_noise, k_step, raw, losses):
        seen.append((it, key.tolist(), k_noise.tolist(), k_step.tolist(),
                     {k: v.copy() for k, v in raw.items()},
                     {k: v.item() for k, v in losses.items()}))
    return _solver(env, out, prefetch).train_model(iters, on_step=on_step)


@pytest.fixture(scope='module')
def straight(env, scratch):
    out = str(scratch / 'straight')
    seen = []
    return _train(env, out, 5, False, seen), seen, out


def _assert_same_run(a, b):
    (sa, seen_a), (sb, seen_b) = a, b
    assert sa.step == sb.step == 5
    for name in sa.params:
        assert torch.equal(sa.params[name], sb.params[name]), name
    for name in sa.momentum:
        assert torch.equal(sa.momentum[name], sb.momentum[name]), name
    assert len(seen_a) == len(seen_b)
    for x, y in zip(seen_a, seen_b):
        assert x[:4] == y[:4]
        for k in x[4]:
            np.testing.assert_array_equal(x[4][k], y[4][k])
        assert x[5] == y[5]


@pytest.mark.parametrize('prefetch', [False, True])
def test_resume_equals_uninterrupted(env, straight, scratch, prefetch):
    state5, seen5, _ = straight
    out = str(scratch / f'resumed{int(prefetch)}')
    seen = []
    s3 = _train(env, out, 3, prefetch, seen)
    assert s3.step == 3
    solver = _solver(env, out, prefetch)
    assert solver.find_previous() == 3
    s5 = solver.train_model(5, on_step=lambda it, *a: seen.append(
        (it, a[0].tolist(), a[1].tolist(), a[2].tolist(),
         {k: v.copy() for k, v in a[3].items()},
         {k: v.item() for k, v in a[4].items()})))
    _assert_same_run((s5, seen), (state5, seen5))
    assert all(np.isfinite(v) for x in seen for v in x[5].values())


def test_snapshots_pruned_and_restored_exactly(env, straight):
    state5, _, out = straight
    cfg = env[0]
    prefix = cfg.TRAIN.SNAPSHOT_PREFIX
    pkls = sorted(f for f in os.listdir(out) if f.endswith('.pkl'))
    # iterations 2 and 4, then 5 at the end; SNAPSHOT_KEPT 1 prunes 2
    # when 4 is written, and the last snapshot is not pruned
    assert pkls == [f'{prefix}_iter_{i}.pkl' for i in (4, 5)]
    assert all(osp.exists(osp.join(out, p[:-4] + '.pt')) for p in pkls)
    solver = _solver(env, out, False)
    from tpudenoise_torch.data.loader import RoiDataLoader
    loader = RoiDataLoader(env[2], 2, cfg, bucket=BUCKET)
    init = solver._init_state_fn(torch.Generator().manual_seed(1), BUCKET)
    got, key, it = solver.restore(init, loader, RoiDataLoader(
        env[2], 2, cfg, bucket=BUCKET), 5)
    assert it == 5 and got.step == 5
    for name in state5.params:
        assert torch.equal(got.params[name], state5.params[name])
    for name in state5.momentum:
        assert torch.equal(got.momentum[name], state5.momentum[name])
    assert key.dtype == np.uint32 and key.shape == (2,)


def test_padded_batch_takes_masked_noise_and_zero_pad(env, scratch):
    solver = _solver(env, str(scratch / 'prep'), False)
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.data.loader import RoiDataLoader
    raw = RoiDataLoader(env[2], 2, env[0], bucket=BUCKET).forward()
    h, w = (int(v) for v in raw['im_info'][0, :2])
    assert (h, w) == (120, 160)
    calls = []
    inner = solver._noise_fn.masked
    solver._noise_fn.masked = lambda k, im, hw: calls.append(hw) or inner(
        k, im, hw)
    batch = solver._prep_batch(prng.PRNGKey(0), raw)
    assert len(calls) == 1
    out = batch['image'].numpy()
    assert (out[0, h:] == 0).all() and (out[0, :, w:] == 0).all()
    assert (out[0, :h, :w] != 0).any()


def test_port_snapshot_loads_in_jax(straight, scratch):
    import jax

    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.models.convert import load_pretrained
    from tpudenoise.models.faster_rcnn import FasterRCNN as JaxRCNN
    from tpudenoise_torch.models.convert import save_params_npz
    state5 = straight[0]
    path = str(scratch / 'port.npz')
    save_params_npz(state5.params, path)
    tree = load_pretrained(path, 'res50')
    # the JAX init's tree and shapes, traced without drawing the weights
    jm = JaxRCNN('res50', num_classes=2, cfg=jcfg())
    want = jax.eval_shape(lambda k: jm.init(k, BUCKET),
                          jax.random.PRNGKey(0))

    def shapes(t):
        return {'/'.join(str(getattr(k, 'key', k)) for k in p):
                tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

    assert shapes(tree) == shapes(want)
    np.testing.assert_array_equal(
        tree['head']['block2']['unit_1']['conv1']['kernel'],
        state5.params['head.block2.unit_1.conv1.weight'].permute(
            2, 3, 1, 0).numpy())


def test_summaries_and_validation_losses(env, scratch):
    """With the summary interval passed at every iteration: the gt image,
    the TRAIN/ SCORE/ ACT/ histograms and the validation losses (the
    step's losses, no update) go to the logger's sinks."""
    import copy
    import json
    cfg = copy.deepcopy(env[0])
    cfg.TRAIN.SUMMARY_INTERVAL = -1
    out = str(scratch / 'summaries')
    solver = _solver((cfg, env[1], env[2]), out, False)
    if not solver.logger.active_sinks:
        pytest.skip('no TensorBoard writer here')
    logged = []
    inner = solver.logger.log_histogram
    solver.logger.log_histogram = lambda tag, v, step=None: (
        logged.append(tag), inner(tag, v, step))
    state = solver.train_model(1)
    solver.logger.close()
    assert state.step == 1
    assert any(t.startswith('TRAIN/head.') for t in logged)
    assert {'SCORE/cls_prob', 'ACT/net_conv/activations'} <= set(logged)
    with open(osp.join(out + '_tb', 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert any('val_total_loss' in r and np.isfinite(r['val_total_loss'])
               for r in recs)
    assert any(f.startswith('events.out.tfevents')
               for f in os.listdir(out + '_tb'))
