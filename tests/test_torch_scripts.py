"""The port's command drivers (`tpudenoise_torch/experiments/scripts/*.sh`)
against the JAX package's (`experiments/scripts/*.sh`), and the port's
`data/mcg_munge.py` against the JAX one, on the CPU.

Each script runs in a temporary working directory with a recording
`python` first on PATH, which writes its argv and the two device
variables and exits 0.  The port's recorded argv must equal the JAX
script's with `tpudenoise_torch.` in place of `tpudenoise.`, and
CUDA_VISIBLE_DEVICES must carry DEVICE where the JAX script sets
JAX_DEVICE_ORDINAL.  Covered: every dataset case and an unknown one,
extra `--set` arguments, `WEIGHT`, the `NET_FINAL` skip, and
convert_vgg16.sh with and without OUT and without SRC.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import json
import os
import os.path as osp
import subprocess
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_SCRIPTS = osp.join(REPO, 'experiments', 'scripts')
PORT_SCRIPTS = osp.join(REPO, 'tpudenoise_torch', 'experiments', 'scripts')
DEVICE_VARS = ('CUDA_VISIBLE_DEVICES', 'JAX_DEVICE_ORDINAL')

SHIM = '''#!{exe}
import json, os, sys
with open(os.environ['SHIM_LOG'], 'a') as f:
    f.write(json.dumps({{'argv': sys.argv[1:], 'env': {{
        k: os.environ.get(k) for k in {vars!r}}}}}) + '\\n')
'''


@pytest.fixture(scope='module')
def shim(tmp_path_factory):
    bin_dir = tmp_path_factory.mktemp('shim_bin')
    path = bin_dir / 'python'
    path.write_text(SHIM.format(exe=sys.executable, vars=DEVICE_VARS))
    path.chmod(0o755)
    return str(bin_dir)


def _run(shim, script_dir, name, args, cwd, env=None, final=None):
    """Run script `name` with args in cwd (a fresh directory); returns
    (returncode, the recorded python calls, the script's output)."""
    os.makedirs(cwd)
    if final:                          # the final snapshot's side file
        os.makedirs(osp.join(cwd, osp.dirname(final)))
        open(osp.join(cwd, final), 'w').close()
    log = osp.join(cwd, 'calls.jsonl')
    base = {k: v for k, v in os.environ.items()
            if k not in DEVICE_VARS + ('WEIGHT',)}
    res = subprocess.run(
        ['bash', osp.join(script_dir, name), *args], cwd=cwd,
        capture_output=True, text=True, timeout=60,
        env={**base, **(env or {}), 'PATH': shim + os.pathsep
             + os.environ['PATH'], 'SHIM_LOG': log})
    calls = []
    if osp.exists(log):
        with open(log) as f:
            calls = [json.loads(line) for line in f]
    return res.returncode, calls, res.stdout + res.stderr


def _both(shim, tmp_path, name, args, env=None, final=None):
    port = _run(shim, PORT_SCRIPTS, name, args, str(tmp_path / 'port'),
                env, final)
    jax = _run(shim, JAX_SCRIPTS, name, args, str(tmp_path / 'jax'), env,
               final)
    return port, jax


def _same_calls(port, jax, device):
    """The port's calls are the JAX script's with the port's modules and
    CUDA_VISIBLE_DEVICES in the place of JAX_DEVICE_ORDINAL."""
    assert port[0] == jax[0] == 0, (port[2][-2000:], jax[2][-2000:])
    assert len(port[1]) == len(jax[1]) == 1
    (p,), (j,) = port[1], jax[1]
    assert p['argv'][:2] == ['-m', j['argv'][1].replace(
        'tpudenoise.', 'tpudenoise_torch.', 1)]
    assert j['argv'][1].startswith('tpudenoise.cli.')
    assert p['argv'][2:] == j['argv'][2:]
    assert p['env'] == {'CUDA_VISIBLE_DEVICES': device,
                        'JAX_DEVICE_ORDINAL': None}
    assert j['env'] == {'CUDA_VISIBLE_DEVICES': None,
                        'JAX_DEVICE_ORDINAL': device}
    return p['argv']


CASES = [('pascal_voc', ()), ('pascal_voc_0712', ()), ('coco', ()),
         ('rrData', ()), ('rrData', ('TRAIN.SCALES', '[400]', 'RNG_SEED',
                                     '5'))]


@pytest.mark.parametrize('dataset,extra', CASES)
@pytest.mark.parametrize('script', ['train_faster_rcnn.sh',
                                    'test_faster_rcnn.sh'])
def test_drivers_make_the_jax_calls(shim, tmp_path, script, dataset,
                                        extra):
    port, jax = _both(shim, tmp_path, script,
                      ['1', dataset, 'res101', 'gaussian_var0.1', *extra])
    argv = _same_calls(port, jax, '1')
    assert argv[argv.index('--cfg') + 1] == 'experiments/cfgs/res101.yml'
    assert argv[argv.index('--noise') + 1] == 'gaussian_var0.1'
    tag = '_'.join(extra) or 'default'
    assert argv[argv.index('--tag') + 1] == tag
    if extra:
        assert argv[-len(extra):] == list(extra)
    logs = os.listdir(tmp_path / 'port' / 'experiments' / 'logs')
    assert len(logs) == 1 and 'gaussian_var0.1' in logs[0]


def test_train_driver_passes_weight_and_skips_a_finished_run(shim,
                                                             tmp_path):
    args = ['0', 'rrData', 'vgg16', 'sap_median_var0.4']
    port, jax = _both(shim, tmp_path / 'w', 'train_faster_rcnn.sh', args,
                      env={'WEIGHT': 'data/imagenet_weights/vgg16.npz'})
    argv = _same_calls(port, jax, '0')
    assert argv[2:4] == ['--weight', 'data/imagenet_weights/vgg16.npz']
    assert argv[argv.index('--iters') + 1] == '5000'
    final = ('output/vgg16/rrData_2021_train/default/'
             'vgg16_faster_rcnn_iter_5000.pkl')
    port, jax = _both(shim, tmp_path / 'skip', 'train_faster_rcnn.sh', args,
                      final=final)
    assert port[0] == jax[0] == 0 and port[1] == jax[1] == []


def test_test_driver_tests_the_final_snapshot(shim, tmp_path):
    port, jax = _both(shim, tmp_path, 'test_faster_rcnn.sh',
                      ['0', 'rrData', 'res101', 'sap_median_var0.4'])
    argv = _same_calls(port, jax, '0')
    assert argv[argv.index('--model') + 1] == (
        'output/res101/rrData_2021_train/default/res101_faster_rcnn_iter_5000')
    assert argv[argv.index('--imdb') + 1] == 'rrData_2021_test'


@pytest.mark.parametrize('script', ['train_faster_rcnn.sh',
                                    'test_faster_rcnn.sh'])
def test_drivers_refuse_an_unknown_dataset(shim, tmp_path, script):
    port, jax = _both(shim, tmp_path, script, ['0', 'kitti', 'res101',
                                               'original'])
    assert port[0] == jax[0] == 1 and port[1] == jax[1] == []
    assert 'No dataset given' in port[2]


@pytest.mark.parametrize('args', [['vgg_16.ckpt'],
                                  ['vgg_16.ckpt', 'weights/v.npz'], []])
def test_convert_driver_makes_the_jax_call(shim, tmp_path, args):
    port, jax = _both(shim, tmp_path, 'convert_vgg16.sh', args)
    if not args:
        assert port[0] == jax[0] == 1 and port[1] == jax[1] == []
        return
    assert port[0] == jax[0] == 0
    (p,), (j,) = port[1], jax[1]
    assert p['argv'] == ['-m', 'tpudenoise_torch.cli.convert'] + \
        j['argv'][2:] and j['argv'][1] == 'tpudenoise.cli.convert'
    out = args[1] if len(args) > 1 else 'data/imagenet_weights/vgg16.npz'
    assert p['argv'][2:] == ['--src', 'vgg_16.ckpt', '--net', 'vgg16',
                             '--out', out]
    assert p['env'] == j['env'] == dict.fromkeys(DEVICE_VARS)
    assert osp.isdir(tmp_path / 'port' / osp.dirname(out))


def test_drivers_are_executable():
    for name in os.listdir(PORT_SCRIPTS):
        assert os.access(osp.join(PORT_SCRIPTS, name), os.X_OK), name


def _mcg_tree(root):
    src = root / 'MCG-COCO-val2014-boxes'
    src.mkdir(parents=True)
    for n in ('COCO_val2014_000000193401.mat',
              'COCO_val2014_000000141334.mat', 'COCO_train2014_00042.mat'):
        (src / n).write_bytes(n.encode())
    return src


def _tree(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_mcg_munge_matches_jax(tmp_path, monkeypatch, capsys):
    from tpudenoise.data.mcg_munge import munge as jmunge
    from tpudenoise_torch.data.mcg_munge import munge
    out = {}
    for name, fn in (('port', munge), ('jax', jmunge)):
        root = tmp_path / name
        src = _mcg_tree(root)
        monkeypatch.chdir(root)
        assert fn(src.name) == 3
        out[name] = (_tree(root), capsys.readouterr().out)
    assert out['port'] == out['jax']
    assert 'MCG/mat/COCO_val2014_0/COCO_val2014_000000193/' \
        'COCO_val2014_000000193401.mat' in out['port'][0]


def test_mcg_munge_main(tmp_path):
    src = _mcg_tree(tmp_path)
    res = subprocess.run([sys.executable, '-m', 'tpudenoise_torch.data.'
                          'mcg_munge', src.name], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, 'PYTHONPATH': REPO})
    assert res.returncode == 0, res.stderr
    assert _tree(tmp_path) == sorted(
        osp.join('MCG', 'mat', n[:14], n[:22], n + '.mat')
        for n in ('COCO_val2014_000000193401', 'COCO_val2014_000000141334',
                  'COCO_train2014_00042'))
