"""The device mesh (counterpart of `tpudenoise/core/mesh.py`), in
PyTorch's idiom: one process per GPU, `torch.distributed` with NCCL on
CUDA and gloo on the CPU, a `DeviceMesh` over the world's ranks, and each
rank holding its own slice of a batch.

    torchrun --nproc-per-node N -m tpudenoise_torch.cli.trainval \\
        --distributed ...

`initialize_distributed` joins the process group (torchrun's environment
by default); `production_mesh` is the mesh the entry points run on, or
None where they run on one device.  `shard_batch` cuts this rank's rows
out of a global batch, `gather_batch` joins every rank's rows again, and
`replicated` broadcasts rank 0's tensors.

Collectives take CUDA tensors as they are, under NCCL (one process a GPU)
and under gloo (several ranks sharing a GPU, which NCCL refuses): gloo
runs all_reduce, broadcast and all_gather on CUDA tensors.  Its send and
receive do not (a CUDA tensor aborted the process on an H100 with torch
2.11), so the spatial halo exchange stages its rows through host memory
under gloo (`parallel/spatial.py`).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           init_method: str | None = None,
                           device: str = 'cuda',
                           backend: str | None = None) -> torch.device:
    """Join the process group; returns this rank's device.

    With no arguments, torchrun's environment: RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT.  coordinator ('host:port'),
    num_processes and process_id override it; init_method (for example
    'file:///tmp/rendezvous') replaces the coordinator.  On CUDA the
    rank's GPU is LOCAL_RANK, set before the group starts; backend
    defaults to 'nccl' there and to 'gloo' on the CPU.  With backend
    'gloo' on CUDA, ranks beyond the host's GPUs share them (rank
    LOCAL_RANK takes GPU LOCAL_RANK % count): several ranks on one GPU,
    which NCCL does not allow."""
    rank = int(process_id if process_id is not None
               else os.environ.get('RANK', 0))
    world = int(num_processes if num_processes is not None
                else os.environ.get('WORLD_SIZE', 1))
    local = int(os.environ.get('LOCAL_RANK', rank))
    if init_method is None:
        init_method = (f'tcp://{coordinator}' if coordinator
                       else 'env://')
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_distributed: device cuda, but '
                               'torch sees no CUDA GPU')
        backend = backend or 'nccl'
        n = torch.cuda.device_count()
        if local >= n and backend == 'nccl':
            raise RuntimeError(f'LOCAL_RANK {local} but {n} GPU(s): NCCL '
                               f'takes one GPU a rank (backend gloo lets '
                               f'ranks share a GPU)')
        dev = torch.device('cuda', local % n)
        torch.cuda.set_device(dev)
        torch.cuda.init()
    else:
        backend = backend or 'gloo'
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return dev


@contextlib.contextmanager
def process_group(init_method: str | None = None, device: str = 'cuda',
                  backend: str | None = None):
    """The entry points' `--distributed`: initialize_distributed unless
    this process already joined a group (an in-process caller's), then
    yields this rank's device; leaves the group it joined at the end."""
    if dist.is_initialized():
        yield (torch.device('cuda', torch.cuda.current_device())
               if device == 'cuda' else torch.device(device))
        return
    dev = initialize_distributed(init_method=init_method, device=device,
                                 backend=backend)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def world_size() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def agree(value, device=None):
    """Rank 0's value (a bool or an int) on every rank; device is this
    rank's, where NCCL needs the tensor."""
    dev = device if dist.get_backend() == 'nccl' else 'cpu'
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return type(value)(t.item())


def make_mesh(mesh_shape=None, axis_names=None):
    """A DeviceMesh over the world's ranks.  mesh_shape entries of -1
    absorb the remaining ranks; axis_names default to ('data',) for one
    axis.  Its device type is 'cuda' under NCCL and 'cpu' under gloo (the
    mesh only names the process groups; every collective here is
    explicit)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    mesh_shape = list(mesh_shape or [-1])
    if axis_names is None:
        axis_names = (['data'] if len(mesh_shape) == 1
                      else [f'axis{i}' for i in range(len(mesh_shape))])
    known = int(np.prod([s for s in mesh_shape if s != -1])) or 1
    shape = [n // known if s == -1 else int(s) for s in mesh_shape]
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} does not cover {n} ranks')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def production_mesh(cfg, batch_size: int | None = None,
                    quiet: bool = False):
    """The mesh the entry points (Solver, test_net_batched) run on:
    cfg.TPU.MESH_SHAPE / MESH_AXES over the process group's ranks when
    there is more than one and the batch divides over them; otherwise
    None (one device, the reference's regime).  A process that sees
    several GPUs but joined no process group runs on one, and says how
    to use them all."""
    if not dist.is_initialized():
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_gpu > 1 and not quiet:
            print(f'NOTE: {n_gpu} GPUs visible but no process group: '
                  f'running on one. For data parallelism run one process '
                  f'a GPU: torchrun --nproc-per-node {n_gpu} -m '
                  f'tpudenoise_torch.cli.<entry> ... --distributed')
        return None
    n = dist.get_world_size()
    if n <= 1:
        return None
    if batch_size is not None and batch_size % n != 0:
        if not quiet:
            print(f'NOTE: batch size {batch_size} does not divide the '
                  f'{n}-device mesh — running single-device. Use a batch '
                  f'that is a multiple of {n} for data parallelism.')
        return None
    return make_mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES)


def axis_size(mesh, axis: str = 'data') -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = 'data') -> int:
    return mesh.get_local_rank(axis)


def batch_rows(mesh, batch: int, axis: str = 'data') -> slice:
    """This rank's rows of a global batch split evenly over `axis`."""
    n = axis_size(mesh, axis)
    if batch % n:
        raise ValueError(f'batch {batch} does not divide over the {n} '
                         f'ranks of axis {axis!r}')
    b = batch // n
    r = axis_rank(mesh, axis)
    return slice(r * b, (r + 1) * b)


def tree_map(fn, tree):
    """fn over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree, axis: str = 'data'):
    """This rank's slice of the leading dimension of each leaf (tensors
    and numpy arrays; leaves without a batch dimension pass through)."""
    def cut(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
            return x[batch_rows(mesh, x.shape[0], axis)]
        return x
    return tree_map(cut, tree)


def replicated(mesh, tree):
    """Every tensor leaf broadcast from rank 0 to every rank of the mesh
    (the world), in place; returns the tree."""
    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x.data, src=0)
        return x
    return tree_map(bcast, tree)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's t (the same shape on each), concatenated on dim 0 in
    rank order."""
    x = t.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def gather_batch(mesh, tree, axis: str = 'data'):
    """The inverse of shard_batch: every rank's rows of each tensor or
    numpy leaf joined on dim 0 over `axis` (every rank gets the whole)."""
    group = mesh.get_group(axis)

    def join(x):
        if isinstance(x, np.ndarray):
            return all_gather_rows(torch.from_numpy(np.ascontiguousarray(
                x)), group).numpy()
        if isinstance(x, torch.Tensor):
            return all_gather_rows(x, group)
        return x
    return tree_map(join, tree)
