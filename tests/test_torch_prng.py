"""The port's numpy threefry key algebra is bit-equal to jax.random
(jax 0.9, jax_threefry_partitionable on, as bench.py sets it)."""

import jax
import numpy as np
import pytest

from tpudenoise_torch.core import prng

SEEDS = list(range(50)) + [3, 2**31 - 1, 2**31, 2**32 - 1, 123456789]


@pytest.fixture(autouse=True)
def _partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


@pytest.mark.parametrize('seed', SEEDS)
def test_key_ops_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_data(k),
                                  np.asarray(jax.random.key_data(jk)))
    for num in (1, 2, 3, 8):
        np.testing.assert_array_equal(
            prng.split(k, num), np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, seed % 997, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(k, data), np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize('index', list(range(0, 100, 2)))
def test_harness_seed_draws_bit_equal(index):
    """The per-image draws of the fused pipelines: fold_in(PRNGKey(3), i)
    then randint seeds (1,) and (B,), and the gaussian level index."""
    jk = jax.random.fold_in(jax.random.PRNGKey(3), index)
    k = prng.fold_in(prng.PRNGKey(3), index)
    np.testing.assert_array_equal(k, np.asarray(jk))
    for shape, lo, hi in (((1,), 0, 2**31 - 1), ((8,), 0, 2**31 - 1),
                          ((1,), 0, 3), ((5,), 0, 3), ((4, 3), -7, 100)):
        np.testing.assert_array_equal(
            prng.randint(k, shape, lo, hi),
            np.asarray(jax.random.randint(jk, shape, lo, hi)))
    k1, k2 = prng.split(k)
    jk1, jk2 = jax.random.split(jk)
    np.testing.assert_array_equal(
        prng.randint(k2, (1,), 0, 3),
        np.asarray(jax.random.randint(jk2, (1,), 0, 3)))
    np.testing.assert_array_equal(
        prng.random_bits(k1, (3, 5)),
        np.asarray(jax.random.bits(jk1, (3, 5), np.uint32)))
