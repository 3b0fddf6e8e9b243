"""Data-parallel training in the port (`train_step.make_train_step(...,
mesh)`, the solver's mesh path and `cli.trainval --distributed`) on the
CPU, with gloo ranks in subprocesses (`tests/torch_ranks.py`).

* Two steps at world 2 against the JAX package's step on a 2-device mesh
  of the `conftest.py` CPU devices (its jit sees the global batch): a
  vgg16 from one JAX init, the heads in f32 in both packages (as
  `tests/test_torch_train_step.py` builds them), batch 2 on a (128, 192)
  bucket, one image a rank.  Each rank takes rows [r, r + 1) of
  split(key, 2), so the ranks' draws are the global batch's.  Bounds are
  that file's: each loss term within LOSS_RTOL; the parameters after
  step 1 within GRAD_TOL of twice the change the JAX step made to the
  tensor (one SGD step from equal parameters moves a tensor by lr * g,
  biases doubled), plus 2 ulp of its largest |p|, with the same
  one-entry allowance in conv4_2's bias (RELU_BOUNDARY); after step 2,
  see `test_world2_params_match_jax_mesh_step`; every frozen parameter
  bit-equal to the init.  The parameters stay replicated: both ranks'
  checksums equal, bit for bit.
* `cli.trainval --distributed --batch 2` at world 2 on the fixture
  dataset (every batch padded into the bucket, so both sides take the
  masked noise with fold_in keys), two iterations of a seeded mobile in
  bf16 (the CLI's dtype), against the single process's `--batch 2` run:
  the logged losses within `tests/test_torch_train_cli.py`'s LOSS_RTOL
  (bf16; the ranks' convolutions run on one image, the single process's
  on two), one snapshot written by rank 0 alone.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import glob
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (BUCKET, LOSS_RTOL, GRAD_TOL,
                                         NUM_CLASSES, RELU_BOUNDARY, SCALES,
                                         _batch, _configs, _flat_jax)
from tests.test_torch_train_cli import LOSS_RTOL as CLI_RTOL
from tests.torch_ranks import REPO, run_ranks

KEYS = (9, 10)

STEP_RANKS = r'''
import os, sys
import numpy as np
import torch
from tpudenoise_torch.core import mesh as M, prng
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.train.train_step import make_train_step

work = sys.argv[1]
M.initialize_distributed(init_method=os.environ['TORCH_DIST_INIT'],
                         device='cpu')
mesh = M.make_mesh()
tc = default_config()
tc.TRAIN.LEARNING_RATE = 0.01
tc.RESNET.FIXED_BLOCKS = 1
model = FasterRCNN('vgg16', num_classes=%d, cfg=tc,
                   anchor_scales=%r, dtype=torch.float32)
model.rcnn.dtype = torch.float32
sd = torch.load(os.path.join(work, 'init.pt'))
model.init = lambda generator, image_shape: {k: sd[k].clone()
                                             for k in model.state_dict()}
init, step = make_train_step(model, tc, mesh=mesh)
state = init(None, None)
batch = M.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in
                             np.load(os.path.join(work, 'batch.npz')).items()})
out = {}
for i, seed in enumerate(%r):
    state, losses = step(state, prng.PRNGKey(seed), batch)
    for k, v in losses.items():
        out[f'{i}/loss/{k}'] = v.numpy()
    for k, v in state.params.items():
        out[f'{i}/param/{k}'] = v.numpy()
flat = torch.cat([v.reshape(-1) for _, v in sorted(state.params.items())])
out['checksum'] = np.frombuffer(flat.numpy().tobytes(), np.uint32).astype(
    np.uint64).sum(keepdims=True)
np.savez(os.path.join(work, f'rank{M.rank()}.npz'), **out)
torch.distributed.destroy_process_group()
assert 'jax' not in sys.modules
print('RANK_OK')
''' % (NUM_CLASSES, SCALES, KEYS)


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """The JAX mesh step and the port's world-2 step, twice each."""
    import functools

    import tpudenoise.models.faster_rcnn as jfr
    from tpudenoise.core.mesh import make_mesh
    from tpudenoise.models.faster_rcnn import FasterRCNN as JaxRCNN
    from tpudenoise.train.train_step import make_train_step as j_make_step
    from tpudenoise_torch.models.convert import from_jax_params
    work = tmp_path_factory.mktemp('dp_step')
    jc, _ = _configs()
    saved = jfr.RCNNHead
    jfr.RCNNHead = functools.partial(saved, dtype=jnp.float32)
    try:
        jmodel = JaxRCNN(backbone='vgg16', num_classes=NUM_CLASSES, cfg=jc,
                         anchor_scales=SCALES, dtype=jnp.float32)
        mesh = make_mesh(devices=jax.devices()[:2])
        j_init, j_step = j_make_step(jmodel, jc, mesh=mesh)
        jstate = j_init(jax.random.PRNGKey(5), BUCKET)
        params = jax.tree_util.tree_map(np.asarray, jstate.params)
        torch.save(from_jax_params(params), str(work / 'init.pt'))
        batch = _batch()
        np.savez(str(work / 'batch.npz'), **batch)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jax_out = [_flat_jax(params)]
        jax_losses = []
        for seed in KEYS:
            jstate, losses = j_step(jstate, jax.random.PRNGKey(seed), jbatch)
            jax_out.append(_flat_jax(jstate.params))
            jax_losses.append({k: float(v) for k, v in losses.items()})
    finally:
        jfr.RCNNHead = saved
    outs = run_ranks(STEP_RANKS, 2, work, args=(str(work),))
    assert all('RANK_OK' in o for o in outs)
    ranks = [dict(np.load(work / f'rank{r}.npz')) for r in range(2)]
    return dict(jax_params=jax_out, jax_losses=jax_losses, ranks=ranks,
                init=torch.load(str(work / 'init.pt')),
                one=_one_process(work))


def _one_process(work):
    """The port's unsharded step on the global batch, twice: the
    parameters after each step (`tests/test_torch_train_step.py` holds one
    such step against the JAX step)."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.models.convert import to_jax_flat
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.train.train_step import make_train_step
    _, tc = _configs()
    model = FasterRCNN('vgg16', num_classes=NUM_CLASSES, cfg=tc,
                       anchor_scales=SCALES, dtype=torch.float32)
    model.rcnn.dtype = torch.float32
    sd = torch.load(str(work / 'init.pt'))
    model.init = lambda generator, image_shape: {
        k: sd[k].clone() for k in model.state_dict()}
    init, step = make_train_step(model, tc)
    state = init(None, None)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = []
    for seed in KEYS:
        state, _ = step(state, prng.PRNGKey(seed), batch)
        out.append(to_jax_flat(state.params))
    return out


def test_world2_losses_match_jax_mesh_step(steps):
    for i, want in enumerate(steps['jax_losses']):
        for r in steps['ranks']:
            for k, w in want.items():
                got = float(r[f'{i}/loss/{k}'])
                assert np.isfinite(got)
                assert abs(got - w) <= LOSS_RTOL * abs(w), (i, k, got, w)


def test_world2_params_match_jax_mesh_step(steps):
    """Step 1 at the one-step bound.  Step 2's parameters carry step 1's
    rounding through the momentum and the second gradient: the port's
    unsharded two steps land past the one-step bound too (conv3_1 to
    conv4_1, up to 4x, measured), so step 2 is held to the unsharded
    port's own distance from the JAX step plus the one-step bound."""
    from tpudenoise_torch.models.convert import to_jax_flat
    jp = steps['jax_params']
    for i in range(len(KEYS)):
        got = to_jax_flat({k[len(f'{i}/param/'):]: torch.from_numpy(v)
                           for k, v in steps['ranks'][0].items()
                           if k.startswith(f'{i}/param/')})
        for name, want in jp[i + 1].items():
            moved = sum(np.abs(jp[s + 1][name] - jp[s][name]).max()
                        for s in range(i + 1))
            ulp2 = 2 * (i + 1) * np.spacing(np.abs(want).max())
            if i > 0:
                ulp2 += np.abs(steps['one'][i][name] - want).max()
            bound = GRAD_TOL * 2 * moved + ulp2
            diff = np.abs(got[name] - want)
            port = name.replace('/', '.').replace('kernel', 'weight')
            if port in RELU_BOUNDARY:
                n_past, tol = RELU_BOUNDARY[port]
                assert (diff > bound).sum() <= n_past, name
                bound = tol * 2 * moved + ulp2
            assert diff.max() <= bound, (i, name, diff.max(), bound)


def test_world2_frozen_and_replicated(steps):
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.core.config import default_config
    model = FasterRCNN('vgg16', num_classes=NUM_CLASSES,
                       cfg=default_config(), anchor_scales=SCALES)
    frozen = [n for n, _ in model.named_parameters() if model.frozen(n)]
    assert frozen
    last = len(KEYS) - 1
    for r in steps['ranks']:
        for n in frozen:
            np.testing.assert_array_equal(r[f'{last}/param/{n}'],
                                          steps['init'][n].numpy())
    a, b = steps['ranks']
    assert a['checksum'] == b['checksum']
    for k in a:
        if '/param/' in k:
            np.testing.assert_array_equal(a[k], b[k])


CLI_RANKS = r'''
import os, sys, json
from tpudenoise_torch.cli import trainval
state = trainval.main(['--dist-init-method', os.environ['TORCH_DIST_INIT']]
                      + sys.argv[1:])
assert state.step == 2
assert 'jax' not in sys.modules
print('RANK_OK')
'''


def test_trainval_distributed_world2_matches_one_process(tmp_path):
    import copy

    import tpudenoise_torch.core.config as tconfig
    from tests.fixtures import make_rrdata_fixture
    from tpudenoise_torch.cli import trainval
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.voc_like import rrData
    root = str(tmp_path)
    make_rrdata_fixture(root, n_train=3, n_test=2, size=(120, 160))
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    for split in ('train', 'test'):
        d = rrData(split, config=cfg)
        cache_pixels.cache(d, cache_pixels.default_pixel_dir(d.name, cfg))

    def argv(tag):
        return ['--device', 'cpu', '--net', 'mobile', '--cfg',
                osp.join(REPO, 'experiments', 'cfgs', 'mobile.yml'),
                '--batch', '2',
                '--imdb', 'rrData_2021_train', '--imdbval',
                'rrData_2021_test', '--iters', '2', '--tag', tag,
                '--no-prefetch', '--set', 'DATA_DIR', root, 'ROOT_DIR',
                root, 'TRAIN.SCALES', '[120]', 'TRAIN.MAX_SIZE', '160',
                'TRAIN.DISPLAY', '1', 'TRAIN.RPN_PRE_NMS_TOP_N', '256',
                'TRAIN.RPN_POST_NMS_TOP_N', '64', 'TRAIN.BATCH_SIZE', '16',
                'ANCHOR_SCALES', '[2, 4, 8]', 'TRAIN.LEARNING_RATE',
                '0.0001']

    outs = run_ranks(CLI_RANKS, 2, tmp_path,
                     args=['--distributed'] + argv('dp2'))
    assert 'training on a 2-rank' in outs[0]
    saved = copy.deepcopy(tconfig.cfg)
    try:
        state = trainval.main(argv('one'))
    finally:
        tconfig.cfg.clear()
        tconfig.cfg.update(saved)
    assert state.step == 2
    def losses(tag):
        path, = glob.glob(osp.join(root, 'tensorboard', '*',
                                   'rrData_2021_train', tag,
                                   'metrics.jsonl'))
        with open(path) as f:
            return {r['_step']: r for r in map(json.loads, f)}

    got, want = losses('dp2'), losses('one')
    assert sorted(got) == sorted(want) == [1, 2]
    for it in (1, 2):
        for k in ('rpn_cross_entropy', 'rpn_loss_box', 'cross_entropy',
                  'loss_box', 'total_loss'):
            g, w = got[it][k], want[it][k]
            assert abs(g - w) <= CLI_RTOL * abs(w) + 1e-6, (it, k, g, w)
    snaps = glob.glob(osp.join(root, 'output', '*', 'rrData_2021_train',
                               'dp2', '*_iter_2.p*'))
    assert len(snaps) == 2, snaps
