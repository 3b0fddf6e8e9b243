"""ctypes bindings of the host C++ box ops in `csrc/native_host.cpp` (the
counterpart of `tpudenoise/ops/native.py`): greedy NMS over (N, 5) dets,
the (N, K) IoU matrix and the single-class box decode, all in f32 on the
host.

The library is built at first use with the host compiler (`c++`, or
`$CXX`) into `build/tpudenoise_torch/native_host-<hash>/`, keyed by a hash
of the source, the flags, the compiler's version and the machine, so a
build directory copied between hosts is never loaded on the wrong one.
A failed build raises with the compiler's message: unlike the JAX
module, nothing falls back to the numpy oracle (`ops.nms.nms_py`), so a
caller always gets the C++ it asked for.
`cfg.USE_NATIVE_NMS` picks `nms_host` over `nms_py` in `cli.reval
--device cpu`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from tpudenoise_torch.cuda_build import BUILD_ROOT, CSRC

SOURCE = osp.join(CSRC, 'native_host.cpp')
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-Wall',
             '-ffp-contract=off')

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get('CXX'), 'c++', 'g++'):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError('no host C++ compiler (c++, g++ or $CXX) to build '
                       f'{SOURCE}')


def library_path() -> str:
    """Where the source builds to: a directory keyed by the hash of the
    source, the flags, the compiler's version and the machine."""
    version = subprocess.run([_cxx(), '--version'], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256('\n'.join([*CXX_FLAGS, version,
                                   platform.machine()]).encode())
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    return osp.join(BUILD_ROOT, f'native_host-{h.hexdigest()[:16]}',
                    'libnative_host.so')


def _build(so: str) -> None:
    os.makedirs(osp.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=osp.dirname(so))
    os.close(fd)
    res = subprocess.run([_cxx(), *CXX_FLAGS, '-o', tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'building {SOURCE} failed:\n{res.stderr}')
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not osp.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        f32p, i32p = (ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int32))
        lib.tpud_nms.restype = ctypes.c_int
        lib.tpud_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_float, i32p]
        lib.tpud_bbox_overlaps.restype = None
        lib.tpud_bbox_overlaps.argtypes = [f32p, ctypes.c_int, f32p,
                                           ctypes.c_int, f32p]
        lib.tpud_bbox_decode.restype = None
        lib.tpud_bbox_decode.argtypes = [f32p, f32p, ctypes.c_int, f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded (a failed build
    raises)."""
    return _load() is not None


def _rows(a, width: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] < width:
        raise ValueError(f'expected (N, {width}) rows, got {a.shape}')
    return np.ascontiguousarray(a[:, :width])


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nms_host(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS of (N, 5) [x1, y1, x2, y2, score] rows: the kept indices
    in greedy order (scores descending, ties in input order), +1 box
    convention, a box kept where its IoU with every kept box is <=
    thresh."""
    dets = _rows(dets, 5)
    lib = _load()
    n = dets.shape[0]
    keep = np.empty(n, dtype=np.int32)
    n_keep = lib.tpud_nms(_fptr(dets), n, ctypes.c_float(thresh),
                          keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keep[:n_keep].tolist()


def bbox_overlaps_host(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) f32 IoU of (N, 4) boxes against (K, 4) query boxes, +1
    convention."""
    boxes, query = _rows(boxes, 4), _rows(query, 4)
    lib = _load()
    n, k = boxes.shape[0], query.shape[0]
    out = np.empty((n, k), dtype=np.float32)
    lib.tpud_bbox_overlaps(_fptr(boxes), n, _fptr(query), k, _fptr(out))
    return out


def bbox_decode_host(boxes: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """(N, 4) boxes with (N, 4) deltas applied (bbox_transform_inv, one
    class)."""
    boxes, deltas = _rows(boxes, 4), _rows(deltas, 4)
    if deltas.shape[0] != boxes.shape[0]:
        raise ValueError(f'{boxes.shape[0]} boxes, {deltas.shape[0]} deltas')
    lib = _load()
    n = boxes.shape[0]
    out = np.empty((n, 4), dtype=np.float32)
    lib.tpud_bbox_decode(_fptr(boxes), _fptr(deltas), n, _fptr(out))
    return out
