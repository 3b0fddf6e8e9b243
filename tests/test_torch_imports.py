"""The port imports nothing of jax, flax or the JAX package.

A subprocess installs a meta-path finder that refuses `jax`, `jaxlib`,
`flax` and `tpudenoise` (and their submodules), imports every module of
`tpudenoise_torch` and loads `chip_smoke.py` with importlib.  Without a
GPU, `chip_smoke.py` exits non-zero and prints no result line.  The
config, its cfg reader and the CLIs also import, apply the repo's cfg
files and answer `--help` with yaml, cv2 and PIL refused as well (the
GPU machine has none of them)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import os.path as osp
import subprocess
import sys
import textwrap

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
REFUSED = ('jax', 'jaxlib', 'flax', 'tpudenoise')


def _run(code, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, 'PYTHONPATH': REPO})


def test_every_module_imports_without_the_jax_package():
    code = textwrap.dedent(f'''
        import importlib, importlib.abc, importlib.util, pkgutil, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {REFUSED!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import tpudenoise_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpudenoise_torch.__path__, 'tpudenoise_torch.')]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            'chip_smoke', 'chip_smoke.py')
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split('.')[0] in {REFUSED!r}]
        print(len(names), bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    n, bad = res.stdout.split(' ', 1)
    assert int(n) >= 34 and bad.strip() == '[]', res.stdout


def test_new_modules_are_walked():
    """The modules that the import test must reach are in the package."""
    import pkgutil

    import tpudenoise_torch
    names = {m.name for m in pkgutil.walk_packages(tpudenoise_torch.__path__,
                                                  'tpudenoise_torch.')}
    assert {'tpudenoise_torch.models.backbones.resnet',
            'tpudenoise_torch.benchmarks.profile_sap_breakdown',
            'tpudenoise_torch.benchmarks.profile_fused',
            'tpudenoise_torch.benchmarks.sass_counts',
            'tpudenoise_torch.data.voc_like',
            'tpudenoise_torch.data.cache_pixels',
            'tpudenoise_torch.data.synthetic',
            'tpudenoise_torch.eval.voc_eval',
            'tpudenoise_torch.utils.image_io',
            'tpudenoise_torch.utils.cfg_reader',
            'tpudenoise_torch.utils.logging',
            'tpudenoise_torch.utils.timer',
            'tpudenoise_torch.utils.profiling',
            'tpudenoise_torch.data.factory',
            'tpudenoise_torch.cli.test',
            'tpudenoise_torch.cli.demo',
            'tpudenoise_torch.cli.trainval',
            'tpudenoise_torch.train.targets',
            'tpudenoise_torch.train.losses',
            'tpudenoise_torch.train.train_step',
            'tpudenoise_torch.train.solver',
            'tpudenoise_torch.data.loader',
            'tpudenoise_torch.data.roidb',
            'tpudenoise_torch.data.prefetch',
            'tpudenoise_torch.data.ds_utils',
            'tpudenoise_torch.denoise.wavelet',
            'tpudenoise_torch.cli.reval',
            'tpudenoise_torch.experiments.noise_grid',
            'tpudenoise_torch.experiments.grid_diff',
            'tpudenoise_torch.data.imdb',
            'tpudenoise_torch.data.coco',
            'tpudenoise_torch.data.coco_api',
            'tpudenoise_torch.denoise.curvelet',
            'tpudenoise_torch.cli.fdct',
            'tpudenoise_torch.analysis.twonn',
            'tpudenoise_torch.benchmarks.profile_curvelet',
            'tpudenoise_torch.models.backbones.mobilenet',
            'tpudenoise_torch.noise.automold',
            'tpudenoise_torch.cli.convert',
            'tpudenoise_torch.core.mesh',
            'tpudenoise_torch.parallel.dp',
            'tpudenoise_torch.parallel.spatial',
            'tpudenoise_torch.models.tf_checkpoint',
            'tpudenoise_torch.ops.native',
            'tpudenoise_torch.utils.visualization',
            'tpudenoise_torch.data.mcg_munge',
            'tpudenoise_torch.examples.smoke'} <= names


def test_new_modules_import_without_tensorflow_cv2_pil_or_yaml(tmp_path):
    """With jax, flax, `tpudenoise`, tensorflow, cv2, PIL and yaml
    refused: mobilenet, automold, the checkpoint reader and the convert
    CLI import; `python -m tpudenoise_torch.cli.convert --help` exits 0,
    and a slim mobilenet checkpoint written by the port's writer goes
    through the CLI's TensorFlow path (conv0 flipped to BGR and divided by
    255 / 2)."""
    refused = REFUSED + ('tensorflow', 'cv2', 'PIL', 'yaml')
    code = textwrap.dedent(f'''
        import importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {refused!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from tpudenoise_torch.cli import convert
        from tpudenoise_torch.models import tf_checkpoint
        from tpudenoise_torch.models.backbones import mobilenet
        from tpudenoise_torch.noise import automold
        sys.argv = ['tpudenoise_torch.cli.convert', '--help']
        try:
            runpy.run_module('tpudenoise_torch.cli.convert',
                             run_name='__main__')
        except SystemExit as e:
            assert e.code in (0, None), e.code
        rng = np.random.RandomState(0)
        arrays = {{}}
        for i in range(14):
            for conv in (['Conv2d_0'] if i == 0 else
                         [f'Conv2d_{{i}}_depthwise', f'Conv2d_{{i}}_pointwise']):
                leaf = 'depthwise_weights' if 'depth' in conv else 'weights'
                arrays[f'MobilenetV1/{{conv}}/{{leaf}}'] = rng.randn(
                    3, 3, 3, 2).astype(np.float32)
                for bn in ('gamma', 'beta', 'moving_mean', 'moving_variance'):
                    arrays[f'MobilenetV1/{{conv}}/BatchNorm/{{bn}}'] = \
                        rng.rand(2).astype(np.float32)
        prefix = {str(tmp_path / 'mobilenet_v1.ckpt')!r}
        tf_checkpoint.write_checkpoint(prefix, arrays)
        tree = convert.main(['--src', prefix, '--net', 'mobile',
                             '--out', prefix + '.npz'])
        conv0 = arrays['MobilenetV1/Conv2d_0/weights']
        assert np.array_equal(tree['head']['layer_0']['conv']['kernel'],
                              conv0[:, :, ::-1] / (255.0 / 2.0))
        assert len(np.load(prefix + '.npz').files) == 135
        bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]
        print('CONVERT OK', bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'CONVERT OK []' in res.stdout, res.stdout[-2000:]
    assert '--detector' in res.stdout


def test_dataset_loop_runs_without_cv2_or_pil(tmp_path):
    """With jax, flax, `tpudenoise`, cv2 and PIL refused (as on the GPU
    machine): the new data, eval and image modules import, and
    `test_net_batched` runs a tiny seeded vgg16 over a numpy-written
    rrData dataset read from its `.npy` pixels, scoring 10 finite APs."""
    refused = REFUSED + ('cv2', 'PIL')
    code = textwrap.dedent(f'''
        import importlib.abc, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {refused!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np, torch
        from tpudenoise_torch.core.config import default_config
        from tpudenoise_torch.data import cache_pixels, synthetic
        from tpudenoise_torch.data.voc_like import rrData
        from tpudenoise_torch.eval import harness, voc_eval
        from tpudenoise_torch.models.faster_rcnn import FasterRCNN
        from tpudenoise_torch.utils import image_io
        root = {str(tmp_path)!r}
        pdir, gt = synthetic.write_rrdata(root, 3, size=(90, 120), seed=1)
        cfg = default_config()
        cfg.DATA_DIR = cfg.ROOT_DIR = root
        cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (90,), 120
        cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 64, 8
        d = rrData('test', config=cfg, pixel_dir=pdir)
        assert image_io.read_bgr(d.image_path_at(0)).shape == (90, 120, 3)
        m = FasterRCNN('vgg16', num_classes=2, cfg=cfg,
                       dtype=torch.float32)
        params = m.init(torch.Generator().manual_seed(0))
        aps = harness.test_net_batched(m, params, d, 'w',
                                       'sap_median_var0.4', eval_batch=2,
                                       config=cfg, bucket=(96, 128))
        assert len(aps) == 10 and np.isfinite(aps).all(), aps
        bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]
        print('LOOP OK', bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'LOOP OK []' in res.stdout, res.stdout[-2000:]


def test_config_and_clis_run_without_yaml_cv2_or_pil():
    """With jax, flax, `tpudenoise`, yaml, cv2 and PIL refused: the config
    applies every cfg file of experiments/cfgs and a `--set` list, and
    `python -m tpudenoise_torch.cli.test --help`, `cli.demo --help`,
    `cli.reval --help`, `cli.fdct --help` and `experiments.noise_grid
    --help` (run through runpy under the refusing finder) exit 0."""
    refused = REFUSED + ('yaml', 'cv2', 'PIL')
    code = textwrap.dedent(f'''
        import glob, importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {refused!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        from tpudenoise_torch.core.config import (cfg_from_file,
                                                  cfg_from_list,
                                                  default_config)
        from tpudenoise_torch.cli import demo, test
        from tpudenoise_torch.data import factory
        files = sorted(glob.glob('experiments/cfgs/*.yml'))
        for path in files:
            c = cfg_from_file(path, into=default_config())
        cfg_from_list(['TEST.SCALES', '[120]', 'EXP_DIR', 'x'], into=c)
        assert c.TEST.SCALES == (120,) and c.ANCHOR_SCALES == [8, 16, 32]
        for name in ('tpudenoise_torch.cli.test', 'tpudenoise_torch.cli.demo',
                     'tpudenoise_torch.cli.reval',
                     'tpudenoise_torch.cli.fdct',
                     'tpudenoise_torch.experiments.noise_grid'):
            sys.argv = [name, '--help']
            try:
                runpy.run_module(name, run_name='__main__')
            except SystemExit as e:
                assert e.code in (0, None), e.code
        bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]
        print('CLI OK', len(files), bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'CLI OK 6 []' in res.stdout, res.stdout[-2000:]
    assert '--eval-batch' in res.stdout and '--conf' in res.stdout
    assert '--compute-id' in res.stdout and '--keep' in res.stdout


def test_training_runs_without_cv2_pil_yaml_optax_or_orbax(tmp_path):
    """With jax, flax, `tpudenoise`, cv2, PIL, yaml, optax and orbax
    refused (the GPU machine has none of them): the training modules
    import, `cli.trainval --help` exits 0, and `cli.trainval --device
    cpu` trains a res50 one iteration on a numpy-written rrData trainval
    set read from its `.npy` pixels (flips from the `.npy` widths), with
    the masked noise of the generic route, and writes its snapshot."""
    refused = REFUSED + ('cv2', 'PIL', 'yaml', 'optax', 'orbax')
    code = textwrap.dedent(f'''
        import importlib.abc, os, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {refused!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        from tpudenoise_torch.cli import trainval
        from tpudenoise_torch.core.config import default_config
        from tpudenoise_torch.data import cache_pixels, synthetic
        from tpudenoise_torch.train import (losses, solver, targets,
                                            train_step)
        from tpudenoise_torch.data import loader, prefetch, roidb
        sys.argv = ['tpudenoise_torch.cli.trainval', '--help']
        try:
            runpy.run_module('tpudenoise_torch.cli.trainval',
                             run_name='__main__')
        except SystemExit as e:
            assert e.code in (0, None), e.code
        root = {str(tmp_path)!r}
        cfg = default_config()
        cfg.ROOT_DIR = root
        synthetic.write_rrdata(root, 2, size=(90, 120), seed=2,
                               image_set='trainval',
                               pixel_dir=cache_pixels.default_pixel_dir(
                                   'rrData_2021_trainval', cfg))
        state = trainval.main([
            '--device', 'cpu', '--net', 'res50', '--imdb',
            'rrData_2021_trainval', '--imdbval', 'rrData_2021_trainval',
            '--iters', '1', '--noise', 'periodic_var100', '--tag', 't',
            '--set', 'DATA_DIR', root, 'ROOT_DIR', root,
            'TRAIN.SCALES', '[90]', 'TRAIN.MAX_SIZE', '120',
            'TRAIN.RPN_PRE_NMS_TOP_N', '128', 'TRAIN.RPN_POST_NMS_TOP_N',
            '32', 'TRAIN.BATCH_SIZE', '8', 'TRAIN.DISPLAY', '1'])
        assert state.step == 1
        out = os.path.join(root, 'output', 'default', 'rrData_2021_trainval',
                           't', 'res101_faster_rcnn_iter_1.pt')
        assert os.path.exists(out), out
        bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]
        print('TRAIN OK', bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'TRAIN OK []' in res.stdout, res.stdout[-2000:]
    assert '--imdbval' in res.stdout


def test_host_tools_run_without_cv2_or_pil(tmp_path):
    """With jax, flax, `tpudenoise`, cv2 and PIL refused (as on the GPU
    machine): the host C++ NMS builds and runs, `draw_bounding_boxes`
    draws, the rpn roidb and proposal recall run on the CPU, and
    `tpudenoise_torch/examples/smoke.py` exits non-zero without a GPU and
    prints no SMOKE OK."""
    refused = REFUSED + ('cv2', 'PIL')
    code = textwrap.dedent(f'''
        import importlib.abc, pickle, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {refused!r}:
                    raise ImportError('refused: ' + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from tpudenoise_torch.core.config import default_config
        from tpudenoise_torch.data import synthetic
        from tpudenoise_torch.data.voc_like import rrData
        from tpudenoise_torch.ops.native import nms_host
        from tpudenoise_torch.utils.visualization import draw_bounding_boxes
        dets = np.array([[0, 0, 10, 10, .9], [1, 1, 10, 10, .8],
                         [20, 20, 30, 30, .7]], np.float32)
        assert nms_host(dets, 0.5) == [0, 2]
        img = draw_bounding_boxes(np.zeros((40, 50, 3)),
                                  np.array([[5, 15, 30, 35, 1]]))
        assert img[15, 5:31].any() and img.dtype == np.uint8
        root = {str(tmp_path)!r}
        pdir, gt = synthetic.write_rrdata(root, 2, size=(60, 80), seed=1,
                                          image_set='trainval')
        cfg = default_config()
        cfg.DATA_DIR = cfg.ROOT_DIR = root
        d = rrData('trainval', config=cfg, pixel_dir=pdir)
        d.device = 'cpu'
        d.config['rpn_file'] = root + '/rpn.pkl'
        with open(d.config['rpn_file'], 'wb') as f:
            pickle.dump([np.asarray(gt[i], np.float32) + 1
                         for i in d.image_index], f)
        d.set_proposal_method('rpn')
        assert 0 < d.evaluate_recall()['ar'] <= 1
        bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]
        print('HOST OK', bad)
    ''')
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'HOST OK []' in res.stdout, res.stdout[-2000:]
    res = subprocess.run([sys.executable, 'tpudenoise_torch/examples/'
                          'smoke.py'], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and 'SMOKE OK' not in res.stdout


def test_chip_smoke_refuses_without_a_gpu():
    res = _run('import runpy; runpy.run_path("chip_smoke.py", '
               'run_name="__main__")')
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
