"""`python -m tpudenoise_torch.cli.trainval --device cpu` beside the JAX
package's `tpudenoise.cli.trainval`, on the CPU: the same flags, a res50
from the same weights (the JAX init written as `.npz`, passed to both
with --weight), two iterations on `tests/fixtures.make_rrdata_fixture`
(JPEGs for JAX, their `.npy` pixels for the port), the bucketed batches
through the masked noise.  Each iteration's logged losses (metrics.jsonl)
within LOSS_RTOL of the JAX CLI's: both compute in bf16 (the CLIs' model
dtype), whose convolutions and products torch and XLA round in other
orders; measured 2.5e-4 at most.  Also: --distributed at a world of one
is the plain CLI bit for bit, --fast-rng trains, and --device cuda exits
without a GPU.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import copy
import json
import os.path as osp

import numpy as np
import pytest
import torch

from tests.fixtures import make_rrdata_fixture

LOSS_RTOL = 1e-3


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_cli'))
    make_rrdata_fixture(root, n_train=3, n_test=2, size=(120, 160))
    import jax

    from tpudenoise.core.config import default_config as jcfg
    from tpudenoise.models.convert import save_params_npz as j_save
    from tpudenoise.models.faster_rcnn import FasterRCNN as JaxRCNN
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import cache_pixels
    from tpudenoise_torch.data.voc_like import rrData
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    for split in ('train', 'test'):
        d = rrData(split, config=cfg)
        cache_pixels.cache(d, cache_pixels.default_pixel_dir(d.name, cfg))
    npz = osp.join(root, 'init.npz')
    params = JaxRCNN('res50', num_classes=2, cfg=jcfg(),
                     anchor_scales=(2, 4, 8)).init(jax.random.PRNGKey(1),
                                                   (128, 160))
    j_save(jax.tree_util.tree_map(np.asarray, params), npz)
    return root, npz


def _argv(root, npz, tag):
    return ['--net', 'res50', '--imdb', 'rrData_2021_train', '--imdbval',
            'rrData_2021_test', '--iters', '2', '--tag', tag, '--weight',
            npz, '--set', 'DATA_DIR', root, 'ROOT_DIR', root,
            'TRAIN.SCALES', '[120]', 'TRAIN.MAX_SIZE', '160',
            'TRAIN.DISPLAY', '1', 'TRAIN.RPN_PRE_NMS_TOP_N', '256',
            'TRAIN.RPN_POST_NMS_TOP_N', '64', 'TRAIN.BATCH_SIZE', '16',
            'ANCHOR_SCALES', '[2, 4, 8]', 'TRAIN.LEARNING_RATE', '0.0001']


def _run(cfg_module, main, argv):
    saved = copy.deepcopy(cfg_module.cfg)
    try:
        return main(argv)
    finally:
        cfg_module.cfg.clear()
        cfg_module.cfg.update(saved)


def _losses(root, tag):
    path = osp.join(root, 'tensorboard', 'default', 'rrData_2021_train', tag,
                    'metrics.jsonl')
    with open(path) as f:
        return {r['_step']: r for r in map(json.loads, f)}


def test_trainval_cli_beside_jax(env):
    import tpudenoise.core.config as jconfig
    import tpudenoise_torch.core.config as tconfig
    from tpudenoise.cli import trainval as jcli
    from tpudenoise_torch.cli import trainval

    root, npz = env
    state = _run(tconfig, trainval.main,
                 ['--device', 'cpu'] + _argv(root, npz, 'port'))
    assert state.step == 2
    _run(jconfig, jcli.main, _argv(root, npz, 'jax'))
    got, want = _losses(root, 'port'), _losses(root, 'jax')
    assert sorted(got) == sorted(want) == [1, 2]
    for it in (1, 2):
        for k in ('rpn_cross_entropy', 'rpn_loss_box', 'cross_entropy',
                  'loss_box', 'total_loss'):
            g, w = got[it][k], want[it][k]
            assert np.isfinite(g)
            assert abs(g - w) <= LOSS_RTOL * abs(w) + 1e-6, (it, k, g, w)
    snap = osp.join(root, 'output', 'default', 'rrData_2021_train', 'port',
                    'res101_faster_rcnn_iter_2')
    assert osp.exists(snap + '.pt') and osp.exists(snap + '.pkl')


@pytest.mark.parametrize('flag,item', [('--fast-rng', 'item 8'),
                                       ('--distributed', 'item 16')])
def test_unported_flags_raise(flag, item, env, capsys, tmp_path):
    """The flags of ROADMAP items 8 and 16, both ported, each train one
    iteration.  --fast-rng: poisson through the counter-hash route,
    finite losses (its noise against the JAX package's:
    tests/test_torch_fast_rng.py).  --distributed: a process group of
    one (gloo, a file rendezvous) has no mesh, so the iteration is the
    plain CLI's bit for bit: its logged losses and its snapshot's
    parameters (the world of two: tests/test_torch_dp_train.py)."""
    import tpudenoise_torch.core.config as tconfig
    from tpudenoise_torch.cli import trainval
    root, npz = env
    argv = _argv(root, npz, 'fast_rng')
    argv[argv.index('--iters') + 1] = '1'
    if flag == '--distributed':
        runs = {}
        for tag, extra in (('plain', []), ('dist1', [
                flag, '--dist-init-method',
                'file://' + str(tmp_path / 'rdv')])):
            argv[argv.index('--tag') + 1] = tag
            state = _run(tconfig, trainval.main,
                         ['--device', 'cpu'] + extra + argv)
            assert state.step == 1
            runs[tag] = state
        names = ('rpn_cross_entropy', 'rpn_loss_box', 'cross_entropy',
                 'loss_box', 'total_loss')
        got, want = _losses(root, 'dist1')[1], _losses(root, 'plain')[1]
        assert [got[k] for k in names] == [want[k] for k in names]
        for k, v in runs['plain'].params.items():
            assert torch.equal(runs['dist1'].params[k], v), k
        return
    state = _run(tconfig, trainval.main, ['--device', 'cpu', flag,
                                          '--noise', 'poisson'] + argv)
    assert state.step == 1
    assert 'backend: cuda:generic+fast_rng' in capsys.readouterr().out
    losses = _losses(root, 'fast_rng')[1]
    assert all(np.isfinite(losses[k]) for k in (
        'rpn_cross_entropy', 'rpn_loss_box', 'cross_entropy', 'loss_box',
        'total_loss'))


def test_cuda_device_without_a_gpu_exits():
    from tpudenoise_torch.cli import trainval
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(SystemExit) as e:
        trainval.main(['--iters', '1'])
    assert e.value.code not in (0, None)
