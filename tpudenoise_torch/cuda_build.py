"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
a build takes seconds) and compiles to its own shared library under
`build/tpudenoise_torch/<name>-<hash>/` at the repository root, keyed by a
hash of the source, the headers of `csrc/` and the flags.  The flags are
fixed:

* `-gencode arch=compute_90a,code=sm_90a` (Hopper);
* `--fmad=false`: XLA on the CPU does not contract `a*b+c`, and the
  reference kernels' float roundings must be reproduced one for one;
* no `--use_fast_math`: `logf`/`cosf`/`sqrtf` and `/` stay IEEE.

Every C entry takes pointers and the stream as `void*` and returns
`cudaGetLastError()`; `launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

CSRC = osp.join(osp.dirname(osp.abspath(__file__)), 'csrc')
BUILD_ROOT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                      'build', 'tpudenoise_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC')

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_lock = threading.Lock()
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on the '
                       'GPU machine (PATH or /usr/local/cuda/bin)')


def build(names) -> None:
    """Build and load several sources at once: one nvcc process each, all
    running together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(library, names))


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` builds to: a directory keyed by the hash of
    the source, the headers of csrc/ (a source may include them) and the
    flags."""
    src = osp.join(CSRC, name + '.cu')
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(osp.join(CSRC, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return osp.join(BUILD_ROOT, f'{name}-{digest}', f'lib{name}.so')


def library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load `csrc/<name>.cu`."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = osp.join(CSRC, name + '.cu')
        so = library_path(name)
        out_dir = osp.dirname(so)
        if not osp.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f'nvcc failed for {src}:\n{res.stderr}')
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
            with open(osp.join(out_dir, 'ptxas.log'), 'w') as f:
                f.write(res.stderr)
        _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def launch(name: str, entry: str, *args) -> None:
    """Call `entry` of `csrc/<name>.cu` on the current CUDA stream.

    args: tensors (passed as data pointers: device memory, or host memory
    where the C signature says so), Python ints (int32) and floats
    (float32), in the C signature's order before the stream."""
    fn = getattr(library(name), entry)
    conv, types = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
            types.append(ctypes.c_void_p)
        elif isinstance(a, float):
            conv.append(ctypes.c_float(a))
            types.append(ctypes.c_float)
        elif isinstance(a, int):
            conv.append(ctypes.c_int(a))
            types.append(ctypes.c_int)
        else:
            raise TypeError(f'unsupported kernel argument {type(a)}')
    stream = torch.cuda.current_stream().cuda_stream
    fn.argtypes = [*types, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'{name}.{entry} launch failed: cudaError {err}')
