"""The port's noise grid (`tpudenoise_torch/experiments/noise_grid.py`)
and its fixture writer against the JAX package's, on the CPU.

* `write_rrdata_fixture`: the XML and image sets byte for byte those of
  `tests/fixtures.make_rrdata_fixture`, and its pixels the arrays that
  fixture JPEG-encodes.  Against the decoded JPEGs (what the JAX grid
  reads) the pixels differ by the JPEG round trip only: a stated,
  measured deviation, large because the background is uniform noise 60
  levels wide, which the JPEG smooths (measured mean |diff| 9.36-9.64
  levels, max 61-63; held below 12 and 64);
* GRID, QUICK_GRID, the flags and the cfg overrides equal to
  `experiments/noise_grid.py`'s (its override lines are executed on the
  JAX package's config and compared key by key), and the overrides
  reach the solver, the step and the freeze filter;
* one grid row (`gaussian_wavelet_var0.1`) through both packages'
  `test_net_batched`, with `tests/test_torch_slice.py`'s fixture and
  config, and its check but for the share matched (see the test);
* a `--device cpu` run of the port's grid (res50, 2 iterations, 2 rows,
  2 + 2 images) writes its results where it is told and nothing at the
  repo root or in the working directory, and a second run restores the
  finished snapshot and trains no step.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import importlib.util
import os
import os.path as osp
import pickle
import re

import numpy as np
import pytest

from tests.fixtures import make_rrdata_fixture
from tests.test_torch_slice import env  # noqa: F401  (the fixture)
from tpudenoise_torch.data.synthetic import write_rrdata_fixture
from tpudenoise_torch.experiments import noise_grid as NG

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_SCRIPT = osp.join(REPO, 'experiments', 'noise_grid.py')


def _jax_grid():
    spec = importlib.util.spec_from_file_location('jax_noise_grid',
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[osp.relpath(osp.join(d, n), root)] = osp.join(d, n)
    return out


@pytest.mark.parametrize('sizes', [None, [(240, 320), (200, 262)]])
def test_fixture_matches_the_jax_fixture(tmp_path, sizes):
    import cv2
    ja, to = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jgt = make_rrdata_fixture(ja, n_train=3, n_test=4, size=(240, 320),
                              seed=3, sizes=sizes)
    tgt = write_rrdata_fixture(to, n_train=3, n_test=4, size=(240, 320),
                               seed=3, sizes=sizes)
    assert {k: [tuple(map(int, b)) for b in v] for k, v in jgt.items()} \
        == tgt
    jf, tf = _files(ja), _files(to)
    text = [k for k in jf if k.endswith(('.xml', '.txt'))]
    assert len(text) == 7 + 4 and set(text) == {
        k for k in tf if k.endswith(('.xml', '.txt'))}
    for k in text:
        with open(jf[k], 'rb') as a, open(tf[k], 'rb') as b:
            assert a.read() == b.read(), k
    diffs = []
    for k, path in jf.items():
        if not k.endswith('.jpg'):
            continue
        name = osp.basename(k)[:-4]
        split = 'train' if name.startswith('tr') else 'test'
        twin = 'trainval' if split == 'train' else 'val'
        px = np.load(osp.join(to, 'pixels', f'rrData_2021_{split}',
                              name + '.npy'))
        np.testing.assert_array_equal(
            px, np.load(osp.join(to, 'pixels', f'rrData_2021_{twin}',
                                 name + '.npy')))
        jpg = cv2.imread(path)
        assert px.shape == jpg.shape and px.dtype == np.uint8
        diffs.append(np.abs(px.astype(np.int32) - jpg))
    d = np.concatenate([x.ravel() for x in diffs])
    print(f'pixels against the decoded JPEGs: mean |diff| {d.mean():.3f}, '
          f'max {d.max()}')
    assert d.mean() < 12 and d.max() < 64


def test_grid_flags_and_overrides_match_the_jax_script(tmp_path):
    jg = _jax_grid()
    assert NG.GRID == jg.GRID and NG.QUICK_GRID == jg.QUICK_GRID
    assert len(NG.GRID) == 41
    want, got = vars(jg.parse_args([])), vars(NG.parse_args([]))
    assert got.pop('device') == 'cuda'
    assert got.pop('workdir') == 'output/noise_grid_torch'
    want.pop('workdir')
    # results land beside the module, never in the working directory
    assert got.pop('out_md') == osp.join(osp.dirname(NG.__file__),
                                         'RESULTS.md')
    assert got.pop('out_json') == osp.join(osp.dirname(NG.__file__),
                                           'RESULTS.json')
    assert (want.pop('out_md'), want.pop('out_json')) == ('RESULTS.md',
                                                         'RESULTS.json')
    assert want == got
    # the script's overrides, executed on the JAX package's config
    src = open(JAX_SCRIPT).read()
    body = src[src.index('    cfg = default_config()\n'):
               src.index('    bucket = (240, 320)\n')]
    from tpudenoise.core.config import default_config
    workdir = str(tmp_path)
    for iters in (5000, 20, 2):
        scope = {'default_config': default_config,
                 'args': type('A', (), {'iters': iters}),
                 'data_root': osp.join(workdir, 'data'), 'workdir': workdir}
        exec(re.sub('(?m)^    ', '', body), scope)
        jc, tc = scope['cfg'], NG.grid_config(workdir, iters)

        def flat(c, prefix=''):
            out = {}
            for k, v in c.items():
                if isinstance(v, dict):
                    out.update(flat(v, prefix + k + '.'))
                else:
                    out[prefix + k] = v
            return out
        jflat, tflat = flat(jc), flat(tc)
        for k, v in jflat.items():
            if k in tflat:
                assert np.array_equal(np.asarray(tflat[k], object),
                                      np.asarray(v, object)), k
        for k in ('TRAIN.WARMUP_ITERS', 'TRAIN.GRAD_CLIP',
                  'RESNET.FIXED_BLOCKS', 'RESNET.FREEZE_ROOT',
                  'TRAIN.SNAPSHOT_ITERS', 'DATA_DIR', 'ROOT_DIR'):
            assert k in tflat and tflat[k] == jflat[k], k
    assert NG.BUCKET == (240, 320)


def test_grid_row_matches_jax(env, monkeypatch):  # noqa: F811
    """gaussian_wavelet_var0.1 through both packages' test_net_batched on
    `tests/test_torch_slice.py`'s fixture and config: the count per
    (class, image) differs by at most one, and >= 90% of the JAX
    detections have a port twin within 0.5 px (the slice's routes hold
    95%; measured 22 of 24 here).  The wavelet string denoises twice, and
    the second pass turns about 14% of the pixels one level the other way
    (`test_torch_wavelet.py::test_wavelet_route_matches_jax`: its floats
    agree within 2e-5, but most lie within 1e-4 of an integer, where the
    u8 cast truncates), a thousand times the share of the slice's routes,
    and a random-init detector moves a box or two on that."""
    from tests.test_torch_slice import match_row
    matched, total = match_row(env, 'gaussian_wavelet_var0.1', monkeypatch)
    assert total > 0 and matched / total >= 0.9, (matched, total)


def test_grid_runs_on_the_cpu(tmp_path, monkeypatch):
    import sys

    import tpudenoise_torch.train.solver as solver_mod
    # the metrics logger without TensorBoard: importing it costs ~10 s here
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    before = set(os.listdir(REPO))
    cwd = tmp_path / 'cwd'
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(NG, 'GRID', ['gaussian_wavelet_var0.1',
                                     'sap_median_var0.4'])
    seen = {'steps': 0, 'cfg': []}
    make = solver_mod.make_train_step

    def counting(model, cfg, **kw):
        seen['cfg'].append(cfg)
        seen['model'] = model
        init, step = make(model, cfg, **kw)

        def step_fn(*a, **k):
            seen['steps'] += 1
            return step(*a, **k)
        return init, step_fn
    monkeypatch.setattr(solver_mod, 'make_train_step', counting)
    out_md, out_json = tmp_path / 'R.md', tmp_path / 'R.json'
    argv = ['--device', 'cpu', '--net', 'res50', '--iters', '2',
            '--n-train', '2', '--n-test', '2', '--eval-batch', '2',
            '--out-md', str(out_md), '--out-json', str(out_json)]
    meta = NG.main(argv)
    assert seen['steps'] == 2
    c = seen['cfg'][0]
    assert (c.TRAIN.WARMUP_ITERS, c.TRAIN.GRAD_CLIP, c.TRAIN.SNAPSHOT_ITERS,
            c.RESNET.FIXED_BLOCKS, c.RESNET.FREEZE_ROOT) == (100, 10.0, 100,
                                                              0, False)
    model = seen['model']
    assert not model.frozen('head.conv1.weight')
    assert not model.frozen('head.block1.unit_1.conv1.weight')
    workdir = cwd / 'output' / 'noise_grid_torch'
    assert (workdir / 'train_res50').is_dir()
    rows = meta['results']
    assert [r['noise'] for r in rows] == NG.GRID
    for r in rows:
        assert 0 <= r['AP@.5'] <= 1 and 0 <= r['AP@[.5,.95]'] <= 1
    with open(out_json) as f:
        assert f.read().startswith('{')
    assert 'gaussian_wavelet_var0.1' in out_md.read_text()
    assert meta['device'] == 'cpu'
    # the second run (one row) restores the finished snapshot and trains
    # no step
    steps = seen['steps']
    monkeypatch.setattr(NG, 'GRID', NG.GRID[1:])
    meta2 = NG.main(argv)
    assert seen['steps'] == steps
    assert [r['AP@.5'] for r in meta2['results']] == [rows[1]['AP@.5']]
    assert set(os.listdir(REPO)) == before
    assert sorted(os.listdir(cwd)) == ['output']
    with open(osp.join(workdir, 'output', 'default', 'rrData_2021_test',
                       'res50_grid_sap_median_var0.4', 'detections.pkl'),
              'rb') as f:
        assert len(pickle.load(f)) == 2


def test_grid_diff_table(tmp_path):
    """`experiments/grid_diff.py`: the rows the two files share, in the
    reference's order, with the port's minus the reference's APs; the
    committed results hold every row of RESULTS.json."""
    import json

    from tpudenoise_torch.experiments import grid_diff
    port = {'results': [{'noise': 'b', 'AP@.5': 0.5, 'AP@[.5,.95]': 0.25},
                        {'noise': 'a', 'AP@.5': 0.9, 'AP@[.5,.95]': 0.4}]}
    ref = {'results': [{'noise': 'a', 'AP@.5': 0.8, 'AP@[.5,.95]': 0.5},
                       {'noise': 'c', 'AP@.5': 0.1, 'AP@[.5,.95]': 0.1},
                       {'noise': 'b', 'AP@.5': 0.5, 'AP@[.5,.95]': 0.2}]}
    rows = grid_diff.diff_rows(port, ref)
    assert rows == [('a', 0.9, 0.8, 0.1, 0.4, 0.5, -0.1),
                    ('b', 0.5, 0.5, 0.0, 0.25, 0.2, 0.05)]
    assert 'max |diff|: AP@.5 0.1000, AP@[.5,.95] 0.1000 over 2 rows' in \
        grid_diff.table(rows)
    paths = []
    for name, d in (('p', port), ('r', ref)):
        paths.append(str(tmp_path / f'{name}.json'))
        with open(paths[-1], 'w') as f:
            json.dump(d, f)
    assert grid_diff.main(['--port', paths[0], '--reference', paths[1]]) \
        == grid_diff.table(rows)
    with open(osp.join(REPO, 'RESULTS.json')) as f:
        want = [r['noise'] for r in json.load(f)['results']]
    with open(osp.join(osp.dirname(NG.__file__), 'RESULTS.json')) as f:
        committed = json.load(f)
    assert [r['noise'] for r in committed['results']] == want
    assert committed['iters'] == 5000 and committed['net'] == 'res101'
