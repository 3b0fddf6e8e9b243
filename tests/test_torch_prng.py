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


@pytest.mark.parametrize('seed', SEEDS[::5])
def test_uniform_bit_equal(seed):
    """Mantissa construction, the contracted scale-and-shift and the
    max(minval, .) clamp: bit-equal for the ranges the port draws."""
    k, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape, lo, hi in (((), 0.05, 0.2), ((7,), 0.0, 1.0),
                          ((3, 5), np.finfo(np.float32).tiny, 1.0),
                          ((64,), -3.0, 2.5)):
        got = prng.uniform(k, shape, lo, hi)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                               maxval=hi)))


@pytest.mark.parametrize('seed', [0, 1, 9])
def test_gumbel_matches_jax(seed):
    """The uniform draw is bit-equal; the two logs are the platform's
    (XLA's CPU log is a polynomial that is not correctly rounded), so the
    bound is 2.5e-7 of max(|value|, 1): two ulps (measured one ulp over
    40 seeds)."""
    got = prng.gumbel(prng.PRNGKey(seed), (8192,))
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (8192,)))
    assert got.dtype == np.float32
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= 2.5e-7


def test_batched_keys_match_one_by_one():
    """A batch of keys (..., 2) gives each key's own result, as
    jax.vmap over the keys does."""
    keys = prng.split(prng.PRNGKey(7), 6).reshape(2, 3, 2)
    flat = keys.reshape(-1, 2)
    for fn, args in ((prng.split, (3,)), (prng.random_bits, ((2, 3),)),
                     (prng.randint, ((4,), -5, 9)), (prng.randint, ((), 0, 3)),
                     (prng.uniform, ((5,), 0.05, 0.2))):
        got = fn(keys, *args)
        want = np.stack([fn(k, *args) for k in flat])
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        assert got.shape[:2] == (2, 3)
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(3), np.arange(5)),
        np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in range(5)]))
    jk = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 42))(
        jax.numpy.asarray(flat)))
    np.testing.assert_array_equal(prng.randint(flat, (), 0, 42), jk)
