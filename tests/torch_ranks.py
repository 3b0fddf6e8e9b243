"""Run a script as the ranks of a gloo process group, one subprocess a
rank, for the port's data- and spatial-parallel tests on the CPU.

Each rank gets RANK, WORLD_SIZE, LOCAL_RANK and TORCH_DIST_INIT (a
`file://` rendezvous in the test's own directory, so that tests running
at once share no port) in its environment, runs with jax refused (the
port imports none of it; the script asserts `'jax' not in sys.modules`
at its end) and writes what it found into files the test reads.
"""

import os
import os.path as osp
import subprocess
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# prepended to each rank's script: jax and the JAX package refused
PRELUDE = '''
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpudenoise'):
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, _Refuse())
'''


def run_ranks(script: str, world: int, workdir, timeout: int = 600,
              args=()) -> list:
    """script's ranks 0 .. world - 1, started together; returns each
    rank's stdout.  Raises with the failing rank's output."""
    workdir = str(workdir)
    rdv = osp.join(workdir, f'rendezvous-{world}-{len(os.listdir(workdir))}')
    path = osp.join(workdir, f'rank_script_{abs(hash(script))}.py')
    with open(path, 'w') as f:
        f.write(PRELUDE + script)
    procs = []
    for r in range(world):
        env = {**os.environ, 'PYTHONPATH': REPO, 'RANK': str(r),
               'WORLD_SIZE': str(world), 'LOCAL_RANK': str(r),
               'TORCH_DIST_INIT': 'file://' + rdv, 'OMP_NUM_THREADS': '1',
               'CUDA_VISIBLE_DEVICES': ''}
        procs.append(subprocess.Popen(
            [sys.executable, path, *map(str, args)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f'rank {r} of {world} exited '
                                     f'{p.returncode}:\n{out[-2000:]}\n'
                                     f'{err[-4000:]}')
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
