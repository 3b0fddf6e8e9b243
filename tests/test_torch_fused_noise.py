"""Plain versions of the port's fused noise kernels against the Pallas
kernels run in interpret mode, and the port's pipelines (seeds included)
against the JAX pipelines with use_pallas=True.

Tolerances: sap + median is integer selection, so bit-exact.  Gaussian +
blur goes through log/cos, whose last-ulp results differ between XLA and
torch; a one-ulp change can move a truncated u8 by one, so the bound is
max |diff| <= 1 on at most 1% of the pixels (the measured share is
printed; it is usually 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.noise.pallas_kernels as pk
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise.pipeline import make_pipeline

SHAPES = [(3, 24, 40), (2, 37, 29)]


def _images(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    return im if dtype == 'u8' else im.astype(np.float32)


def _seeds(n, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randint(-2**31, 2**31 - 1, n).astype(np.int32)


def _gauss_close(got, want, share_limit=0.01):
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    share = float((diff.max(-1) > 0).mean())
    print(f'gaussian+blur: max |diff| {diff.max()}, changed share {share:.2e}')
    assert diff.max() <= 1.0
    assert share <= share_limit


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('dtype', ['u8', 'f32'])
@pytest.mark.parametrize('double', [True, False])
def test_sap_median_plain_bitexact(shape, dtype, double):
    im, seeds = _images(shape, dtype), _seeds(shape[0])
    want = np.asarray(pk.fused_sap_median_batched(
        jnp.asarray(im), jnp.asarray(seeds), 0.4, double, tile_h=16,
        interpret=True))
    got = fk.fused_sap_median_batched(torch.from_numpy(im),
                                      torch.from_numpy(seeds), 0.4,
                                      double).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('dtype', ['u8', 'f32'])
@pytest.mark.parametrize('double', [True, False])
def test_gaussian_blur_plain_matches(shape, dtype, double):
    im, seeds = _images(shape, dtype), _seeds(shape[0])
    sig = np.sqrt(np.asarray([0.1, 1.0, 1.5], np.float32))[
        np.arange(shape[0]) % 3]
    for sigmas in (None, sig):
        kw = {} if sigmas is None else {'sigmas': jnp.asarray(sigmas)}
        want = np.asarray(pk.fused_gaussian_blur(
            jnp.asarray(im), jnp.asarray(seeds), 0.1, double, tile_h=16,
            interpret=True, **kw))
        kw = {} if sigmas is None else {'sigmas': torch.from_numpy(sigmas)}
        got = fk.fused_gaussian_blur(torch.from_numpy(im),
                                     torch.from_numpy(seeds), 0.1, double,
                                     **kw).numpy()
        assert got.dtype == want.dtype
        _gauss_close(got, want)


def test_blur_without_noise_bitexact():
    """var == 0: no transcendental math, so the blur pair is exact."""
    im, seeds = _images((2, 37, 29), 'u8'), _seeds(2)
    want = np.asarray(pk.fused_gaussian_blur(
        jnp.asarray(im), jnp.asarray(seeds), 0.0, True, tile_h=16,
        interpret=True))
    got = fk.fused_gaussian_blur(torch.from_numpy(im),
                                 torch.from_numpy(seeds), 0.0, True).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_matches_pallas_hash():
    rng = np.random.RandomState(5)
    iy = rng.randint(0, 2**31 - 1, 64).astype(np.int32)
    ix = rng.randint(0, 2**31 - 1, 64).astype(np.int32)
    seed = rng.randint(-2**31, 2**31 - 1, 64).astype(np.int32)
    want = np.asarray(pk._hash2d(jnp.asarray(iy), jnp.asarray(ix),
                                 jnp.asarray(seed)))
    t = lambda a: torch.from_numpy(a.astype(np.int64) & 0xFFFFFFFF)
    got = fk.hash2d(t(iy), t(ix), t(seed)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_wrappers_reject_bad_inputs():
    im = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fk.fused_sap_median_batched(im, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        fk.fused_sap_median_batched(im.to(torch.int16),
                                    torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.fused_gaussian_blur(im, torch.zeros(2, dtype=torch.int64))


@pytest.fixture
def pallas_interpret(monkeypatch):
    for name in ('fused_sap_median_batched', 'fused_gaussian_blur'):
        monkeypatch.setattr(pk, name, functools.partial(
            getattr(pk, name), interpret=True))


@pytest.mark.parametrize('noise', ['sap_median_var0.4',
                                   'gaussian_gaus_blur_var0.1'])
@pytest.mark.parametrize('f32_input', [False, True])
def test_pipeline_keyed_matches_jax(pallas_interpret, noise, f32_input):
    from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
    jax.config.update('jax_threefry_partitionable', True)
    jfn = jax_make_pipeline(noise, mode='TEST', use_pallas=True)
    fn = make_pipeline(noise, mode='TEST')
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 256, (4, 24, 40, 3))
    if f32_input:   # non-integral input exercises _to_u8's round + clip
        raw = raw + rng.uniform(-0.6, 0.6, raw.shape)
    raw = raw.astype(np.float32)
    idx = np.asarray([0, 5, 11, 2], np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(3), i))(jnp.asarray(idx))
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in idx])
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    want = np.asarray(jfn.keyed(jkeys, jnp.asarray(raw)))
    images = torch.from_numpy(raw if f32_input else raw.astype(np.uint8))
    got = fn.keyed(keys, images).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if noise.startswith('sap'):
        np.testing.assert_array_equal(got, want)
    else:
        _gauss_close(got, want)
    # the single-key entry draws (B,) seeds from one key
    want1 = np.asarray(jfn(jax.random.PRNGKey(9), jnp.asarray(raw)))
    got1 = fn(prng.PRNGKey(9), images).numpy()
    if noise.startswith('sap'):
        np.testing.assert_array_equal(got1, want1)
    else:
        _gauss_close(got1, want1)
    np.testing.assert_array_equal(fn.masked(keys, images, None).numpy(), got)


def test_other_plans_raise():
    for noise in ('original', 'sap_var0.4', 'bilateral',
                  'noise_mix_var_low_wavelet', 'gaussian_median_var0.1',
                  'speckle_median_var1.0', 'speckle_bilateral_var1.0',
                  'bloom_median'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            make_pipeline(noise)
