"""The port's host C++ box ops (`tpudenoise_torch/ops/native.py` over its
own `csrc/native_host.cpp`) against the JAX package's (`tpudenoise/ops/
native.py`, which builds here as `tests/test_native.py` relies on) and
against the numpy `nms_py`, on the CPU:

* `nms_host` equal to the JAX native NMS and to `nms_py` (no tied
  scores), and on tied scores to `nms_dets` (both take ties in input
  order); `bbox_overlaps_host` and `bbox_decode_host` bit-equal to the
  JAX native ones, the overlaps also to the port's `ops.boxes`;
* `cli.reval`'s `apply_nms_all` on `--device cpu` bit-equal to the JAX
  CLI's under both values of `cfg.USE_NATIVE_NMS`, each value taking its
  own function (`nms_host` or `nms_py`);
* a build that fails raises with the compiler's message.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from tpudenoise.ops import native as jnative
from tpudenoise.ops.nms import nms_py as j_nms_py
from tpudenoise_torch.ops import native
from tpudenoise_torch.ops.nms import nms_dets, nms_py


@pytest.fixture(scope='module', autouse=True)
def built():
    assert jnative.native_available(), 'the JAX native lib must build here'
    assert native.native_available()


def _dets(rng, n, ties=False):
    x1 = rng.uniform(0, 300, n)
    y1 = rng.uniform(0, 300, n)
    w = rng.uniform(5, 120, n)
    h = rng.uniform(5, 120, n)
    s = (rng.randint(0, 4, n) / 4.0 if ties else rng.uniform(0, 1, n))
    return np.stack([x1, y1, x1 + w, y1 + h, s], 1).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('thresh', [0.3, 0.5, 0.7])
def test_nms_host_matches_jax_native_and_nms_py(seed, thresh):
    d = _dets(np.random.RandomState(seed), 400)
    got = native.nms_host(d, thresh)
    assert got == jnative.nms_host(d, thresh)
    assert got == nms_py(d, thresh) == j_nms_py(d, thresh)
    assert 0 < len(got) < 400


def test_nms_host_on_ties_takes_input_order():
    rng = np.random.RandomState(5)
    for n in (1, 8, 64, 300):
        d = _dets(rng, n, ties=True)
        assert native.nms_host(d, 0.3) == nms_dets(d, 0.3, 'cpu') == \
            jnative.nms_host(d, 0.3)
    assert native.nms_host(np.zeros((0, 5), np.float32), 0.5) == []


def test_overlaps_and_decode_match_jax_native():
    from tpudenoise_torch.ops.boxes import bbox_overlaps
    rng = np.random.RandomState(3)
    b, q = _dets(rng, 50)[:, :4], _dets(rng, 20)[:, :4]
    got = native.bbox_overlaps_host(b, q)
    np.testing.assert_array_equal(got, jnative.bbox_overlaps_host(b, q))
    np.testing.assert_array_equal(got, bbox_overlaps(
        torch.from_numpy(b), torch.from_numpy(q)).numpy())
    d = (rng.randn(50, 4) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(native.bbox_decode_host(b, d),
                                  jnative.bbox_decode_host(b, d))
    with pytest.raises(ValueError):
        native.bbox_decode_host(b, d[:10])


@pytest.mark.parametrize('use_native', [True, False])
def test_reval_cpu_follows_use_native_nms(monkeypatch, use_native):
    from tpudenoise.cli.reval import apply_nms_all as j_apply
    from tpudenoise.core.config import cfg as jcfg
    from tpudenoise_torch.cli import reval
    from tpudenoise_torch.core.config import cfg
    monkeypatch.setattr(jcfg, 'USE_NATIVE_NMS', use_native)
    monkeypatch.setattr(cfg, 'USE_NATIVE_NMS', use_native)
    assert reval.nms_function('cpu') is (native.nms_host if use_native
                                         else nms_py)
    rng = np.random.RandomState(7)
    boxes = [[np.zeros((0, 5), np.float32)] * 4, []]
    for n in (0, 1, 40, 250):
        d = _dets(rng, n)
        if n > 5:
            d[3, 2] = d[3, 0]                    # degenerate: x2 == x1
        boxes[1].append(d)
    got, want = reval.apply_nms_all(boxes, 0.3, 'cpu'), j_apply(boxes, 0.3)
    for c in range(2):
        for a, b in zip(got[c], want[c]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(len(x) for x in got[1]) > 0


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('extern "C" int tpud_nms( {\n')
    monkeypatch.setattr(native, 'SOURCE', str(bad))
    with pytest.raises(RuntimeError, match='error'):
        native._build(str(tmp_path / 'out' / 'libbroken.so'))
    assert not list((tmp_path / 'out').glob('*.so'))
