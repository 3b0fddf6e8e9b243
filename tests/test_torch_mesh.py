"""The port's `core/mesh.py` on the CPU: joining a process group, the
mesh, the production mesh's three ways to None, and the batch helpers.

In process: `initialize_distributed` reads torchrun's environment (or
its arguments) and picks gloo on the CPU (the group's start patched
out); without a process group `production_mesh` is None, and a process
that sees several GPUs says how to use them; a world of one (a real
gloo group) is None too.  In four gloo ranks (subprocesses): `make_mesh`
lays -1 over the remaining ranks as the JAX package's does (its (2, -1)
mesh on the 8 CPU devices, beside), `production_mesh` is the 'data' mesh
for a batch the ranks divide and None, with the JAX package's NOTE, for
one they do not; `shard_batch` / `gather_batch` round-trip a tree of
tensors and numpy arrays; `replicated` broadcasts rank 0's tensors;
`agree` hands every rank rank 0's value.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os

import numpy as np
import pytest
import torch

from tests.torch_ranks import run_ranks

RANKS = r'''
import os, sys
import numpy as np
import torch
from tpudenoise_torch.core import mesh as M
from tpudenoise_torch.core.config import default_config

dev = M.initialize_distributed(init_method=os.environ['TORCH_DIST_INIT'],
                               device='cpu')
assert dev == torch.device('cpu') and M.world_size() == 4
r = M.rank()
m = M.make_mesh([2, -1], ['data', 'spatial'])
assert tuple(m.shape) == (2, 2) and m.mesh_dim_names == ('data', 'spatial')
assert M.axis_size(m, 'data') == 2 and M.axis_rank(m, 'spatial') == r % 2
cfg = default_config()
mesh = M.production_mesh(cfg, 8)
assert mesh is not None and tuple(mesh.shape) == (4,)
assert mesh.mesh_dim_names == ('data',)
assert M.production_mesh(cfg, 6) is None
tree = {'a': torch.arange(8 * 3).reshape(8, 3),
        'b': [np.arange(8, dtype=np.float32), 7]}
mine = M.shard_batch(mesh, tree)
assert mine['a'].tolist() == tree['a'][2 * r:2 * r + 2].tolist()
assert mine['b'][0].tolist() == [2 * r, 2 * r + 1] and mine['b'][1] == 7
back = M.gather_batch(mesh, mine)
assert torch.equal(back['a'], tree['a'])
np.testing.assert_array_equal(back['b'][0], tree['b'][0])
try:
    M.batch_rows(mesh, 6)
    raise SystemExit('a batch of 6 over 4 ranks did not raise')
except ValueError:
    pass
x = M.replicated(mesh, {'w': torch.full((3,), float(r))})
assert x['w'].tolist() == [0.0, 0.0, 0.0]
assert M.agree(r + 5) == 5 and M.agree(r == 0) is True
torch.distributed.destroy_process_group()
assert 'jax' not in sys.modules
print('RANK_OK')
'''


def test_four_ranks(tmp_path):
    outs = run_ranks(RANKS, 4, tmp_path)
    assert all('RANK_OK' in o for o in outs)
    assert all('batch size 6 does not divide the 4-device mesh' in o
               for o in outs)
    from tpudenoise.core.mesh import make_mesh
    assert make_mesh([2, -1], ['data', 'spatial']).devices.shape == (2, 4)


def test_initialize_distributed_reads_the_environment(monkeypatch):
    import torch.distributed as dist
    from tpudenoise_torch.core import mesh as M
    calls = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setenv('RANK', '3')
    monkeypatch.setenv('WORLD_SIZE', '4')
    assert M.initialize_distributed(device='cpu') == torch.device('cpu')
    assert calls[-1] == ('gloo', {'init_method': 'env://', 'world_size': 4,
                                  'rank': 3})
    M.initialize_distributed('host:1234', 2, 1, device='cpu')
    assert calls[-1] == ('gloo', {'init_method': 'tcp://host:1234',
                                  'world_size': 2, 'rank': 1})
    M.initialize_distributed(init_method='file:///x', device='cpu',
                             backend='gloo')
    assert calls[-1][1]['init_method'] == 'file:///x'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            M.initialize_distributed(device='cuda')


def test_production_mesh_without_a_group(monkeypatch, capsys, tmp_path):
    import torch.distributed as dist
    from tpudenoise_torch.core import mesh as M
    from tpudenoise_torch.core.config import default_config
    cfg = default_config()
    assert not dist.is_initialized()
    assert M.production_mesh(cfg, 8) is None
    assert 'NOTE' not in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert M.production_mesh(cfg, 8) is None
    assert 'torchrun --nproc-per-node 4' in capsys.readouterr().out
    assert M.production_mesh(cfg, 8, quiet=True) is None
    assert capsys.readouterr().out == ''
    monkeypatch.undo()
    # a world of one: a real gloo group, no mesh
    M.initialize_distributed(None, 1, 0, device='cpu',
                             init_method='file://' + str(tmp_path / 'rdv'))
    try:
        assert M.world_size() == 1 and M.production_mesh(cfg, 8) is None
    finally:
        dist.destroy_process_group()


def test_cli_flags():
    from tpudenoise_torch.cli.test import parse_args as pa_test
    from tpudenoise_torch.cli.trainval import parse_args as pa_train
    for pa in (pa_train, pa_test):
        a = pa(['--distributed', '--dist-backend', 'gloo',
                '--dist-init-method', 'file:///tmp/x'])
        assert a.distributed and a.dist_backend == 'gloo'
        assert a.dist_init_method == 'file:///tmp/x'
        assert pa([]).dist_backend is None
