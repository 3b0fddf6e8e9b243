"""The port's bloom route against the JAX package's: `bloom_params`
bit-equal to `generators.bloom_params` (its f32 linspace included), the
plain compositing bit-equal to `bloom_pallas` in interpret mode and to
`generators.bloom_apply_scan`, and `make_pipeline('bloom')` against the
JAX generic route with `use_pallas=True`.  Bloom is selects, adds,
multiplies and a half-even round in one fixed order, so every comparison
is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.noise.pallas_bloom as pb
from tpudenoise.noise import generators as G
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import generators as TG
from tpudenoise_torch.noise.bloom import bloom_batched
from tpudenoise_torch.noise.pipeline import make_pipeline


@pytest.fixture(autouse=True)
def _partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


@pytest.mark.parametrize('hw', [(24, 40), (160, 200), (600, 1000),
                                (1000, 600)])
def test_bloom_params_bit_equal(hw):
    h, w = hw
    keys = jax.random.split(jax.random.PRNGKey(h + w), 32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: G.bloom_params(k, h, w)))(keys))
    got = np.stack([TG.bloom_params(np.asarray(k), h, w) for k in keys])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # a batch of keys at once, as the pipeline draws them
    np.testing.assert_array_equal(TG.bloom_params(np.asarray(keys), h, w),
                                  want)


def test_linspace_matches_jnp():
    for lo, hi, n in ((0.0, 1.0, 40), (1.0, 400.0, 40), (-3.0, 7.5, 17)):
        np.testing.assert_array_equal(TG._linspace32(lo, hi, n),
                                      np.asarray(jnp.linspace(lo, hi, n)))


@pytest.mark.parametrize('dtype', ['u8', 'f32'])
def test_bloom_plain_matches_pallas(dtype):
    rng = np.random.RandomState(4)
    b, h, w = 3, 70, 130
    imgs = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    if dtype == 'f32':       # non-integral u8-domain floats composite as is
        imgs = imgs + rng.uniform(-0.4, 0.4, imgs.shape).astype(np.float32)
    params = np.stack([TG.bloom_params(k, 600, 1000)
                       for k in prng.split(prng.PRNGKey(2), b)])
    params[:, :8, 0] = [[5, 60, 120, 30, 90, 10, 100, 70]] * b  # on-image
    want = np.stack([np.asarray(pb.bloom_pallas(
        jnp.asarray(imgs[i], jnp.float32), jnp.asarray(params[i]),
        interpret=True)) for i in range(b)])
    scan = np.asarray(jax.vmap(G.bloom_apply_scan)(
        jnp.asarray(imgs, jnp.float32), jnp.asarray(params)))
    got = bloom_batched(torch.from_numpy(imgs),
                        torch.from_numpy(params)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, scan)


def test_bloom_pipeline_keyed_matches_jax(monkeypatch):
    from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
    monkeypatch.setattr(pb, 'bloom_pallas', functools.partial(
        pb.bloom_pallas, interpret=True))
    jfn = jax_make_pipeline('bloom', mode='TEST', use_pallas=True)
    fn = make_pipeline('bloom')
    assert fn.backend == 'cuda:generic'
    rng = np.random.RandomState(6)
    raw = rng.randint(0, 256, (4, 130, 220, 3)).astype(np.uint8)
    idx = np.asarray([0, 3, 17, 5])
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(3), i))(jnp.asarray(idx))
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in idx])
    want = np.asarray(jfn.keyed(jkeys, jnp.asarray(raw, jnp.float32)))
    np.testing.assert_array_equal(fn.keyed(keys, torch.from_numpy(raw))
                                  .numpy(), want)
    want1 = np.asarray(jfn(jax.random.PRNGKey(8),
                           jnp.asarray(raw, jnp.float32)))
    np.testing.assert_array_equal(
        fn(prng.PRNGKey(8), torch.from_numpy(raw)).numpy(), want1)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fn.masked(keys, torch.from_numpy(raw), None)


def test_bloom_wrapper_rejects_bad_inputs():
    im = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        bloom_batched(im, torch.zeros((2, 47, 8)))
    with pytest.raises(TypeError):
        bloom_batched(im.to(torch.int16), torch.zeros((2, 48, 8)))
    with pytest.raises(ValueError):
        bloom_batched(im, torch.zeros((2, 48, 8), dtype=torch.float64))
