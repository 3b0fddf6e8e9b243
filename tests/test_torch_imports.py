"""The port imports nothing of jax, flax or the JAX package.

A subprocess installs a meta-path finder that refuses `jax`, `jaxlib`,
`flax` and `tpudenoise` (and their submodules), imports every module of
`tpudenoise_torch` and loads `chip_smoke.py` with importlib.  Without a
GPU, `chip_smoke.py` exits non-zero and prints no result line."""

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
            'tpudenoise_torch.benchmarks.profile_fused'} <= names


def test_chip_smoke_refuses_without_a_gpu():
    res = _run('import runpy; runpy.run_path("chip_smoke.py", '
               'run_name="__main__")')
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
