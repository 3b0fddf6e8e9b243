"""The port's threefry field draws (`core.prng`: `draw_bits`,
`draw_uniform`, `draw_normal`, `draw_erf_inv`, and the host `normal`)
against jax.random on the CPU (jax 0.9, jax_threefry_partitionable on).

On the CPU the draws run the threefry kernel's plain torch version; on a
GPU the kernel (`csrc/threefry.cu`), held against the same plain version
in tests/test_torch_cuda.py and chip_smoke.py.

Bounds, each with its reason:
* bits and uniforms: bit-equal (integer hashing, an exact mantissa
  construction and one contracted multiply-add);
* normals: XLA's CPU log1p inside erf_inv is not correctly rounded, so a
  draw can differ in its last bits: measured over 2M draws 99.06%
  bit-equal, 99.93% within 2 ulp, none beyond 3 ulp; the test holds >=
  98% bit-equal, >= 99.8% within 2 ulp and <= 3 ulp.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise_torch.core import prng


@pytest.fixture(autouse=True)
def _partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


def _keys(seed, k):
    keys = prng.split(prng.PRNGKey(seed), k)
    return keys, jnp.asarray(keys)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize('seed,k,n', [(0, 1, 1), (3, 4, 5000),
                                      (2**31 - 1, 3, 7919)])
def test_bits_bit_equal(seed, k, n):
    keys, jk = _keys(seed, k)
    got = prng.draw_bits(keys, n, 'cpu')
    assert got.dtype == torch.int32 and got.shape == (k, n)
    want = np.asarray(jax.vmap(lambda q: jax.random.bits(q, (n,),
                                                         jnp.uint32))(jk))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  prng.random_bits(keys, (n,)))


@pytest.mark.parametrize('lo,hi', [(0.0, 1.0), (0.0, 0.6),
                                   (float(np.finfo(np.float32).tiny), 1.0),
                                   (-0.999999940395355, 1.0)])
def test_uniform_bit_equal(lo, hi):
    keys, jk = _keys(7, 3)
    got = prng.draw_uniform(keys, 6000, 'cpu', lo, hi).numpy()
    want = np.asarray(jax.vmap(lambda q: jax.random.uniform(
        q, (6000,), minval=lo, maxval=hi))(jk))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', [1, 11])
def test_normal_within_bound(seed):
    keys, jk = _keys(seed, 4)
    n = 50000
    want = np.asarray(jax.vmap(lambda q: jax.random.normal(q, (n,)))(jk))
    for got in (prng.draw_normal(keys, n, 'cpu').numpy(),
                prng.normal(keys, (n,))):
        u = _ulps(got, want)
        print(f'bit-equal {np.mean(u == 0):.4f}, <= 2 ulp '
              f'{np.mean(u <= 2):.5f}, max {u.max()}')
        assert np.mean(u == 0) >= 0.98
        assert np.mean(u <= 2) >= 0.998
        assert u.max() <= 3


def test_folded_factor_and_erf_inv():
    """`normal * c` as XLA evaluates it: erf_inv(u) * f32(sqrt(2) * c), and
    the bare erf_inv, against jax's own erfinv of the same uniform."""
    keys, jk = _keys(5, 2)
    n = 20000
    u = jax.vmap(lambda q: jax.random.uniform(
        q, (n,), minval=prng.NORMAL_LO, maxval=1.0))(jk)
    ei = np.asarray(jax.scipy.special.erfinv(u))
    got = prng.draw_erf_inv(keys, n, 'cpu').numpy()
    assert np.mean(_ulps(got, ei) == 0) >= 0.98
    sd = np.sqrt(np.float32(0.5))
    scaled = prng.draw_normal(keys, n, 'cpu', sd).numpy()
    np.testing.assert_array_equal(scaled, got * (prng._SQRT2 * sd))


def test_draw_refusals():
    with pytest.raises(ValueError):
        prng.threefry_draw(torch.zeros((2, 3), dtype=torch.int64), 4, 'bits')
    with pytest.raises(ValueError):
        prng.threefry_draw(torch.zeros((2, 2), dtype=torch.int64), 0, 'bits')
    with pytest.raises(ValueError):
        prng.threefry_draw(torch.zeros((2, 2), dtype=torch.int64,
                                       device='meta'), 4, 'bits')
