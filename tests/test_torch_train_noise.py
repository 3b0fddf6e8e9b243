"""The bucketed (masked) noise path of the port's per-image routes against
the JAX package's `run_masked` (`make_pipeline(..., use_pallas=True)`,
its Pallas kernels in interpret mode), on the CPU: images edge-padded to
a (40, 56) canvas with each image's valid (h, w) below it, per-image
fold_in keys, the TRAIN plans.

Bounds as in tests/test_torch_generic_route.py: bit-exact for original,
periodic (both levels), quant, bloom, sap, uniform + mean and the
bilateral route; brownian (prefix sums in another fixed order) within 1
on < 1e-3 of the elements; gaussian's [0, 1] floats within 2.5e-7 (the
erf_inv's last ulp).  At full extent (hw = the canvas) masked equals
keyed bit for bit wherever the JAX package's does.  The mix routes'
masked (the mix scan) matches the JAX package's within the same bounds.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.pallas_bilateral as pbl
import tpudenoise.noise.pallas_bloom as pb
from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
from tpudenoise_torch.noise.pipeline import make_pipeline

CANVAS = (40, 56)
HW = np.array([[31, 47], [40, 50], [25, 56]], np.int32)
NOISES = ['original', 'brownian_var0.09', 'periodic_var100',
          'periodic_varsize', 'quant_var7', 'bloom', 'sap_var0.4',
          'uniform_mean_var0.6', 'speckle_bilateral_var1.0',
          'gaussian_var0.1']
EXACT = {'original', 'periodic_var100', 'periodic_varsize', 'quant_var7',
         'bloom', 'sap_var0.4', 'uniform_mean_var0.6',
         'speckle_bilateral_var1.0'}


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    saved = pbl.bilateral_pallas, pb.bloom_pallas
    pbl.bilateral_pallas = functools.partial(saved[0], interpret=True)
    pb.bloom_pallas = functools.partial(saved[1], interpret=True)
    yield
    pbl.bilateral_pallas, pb.bloom_pallas = saved
    jax.config.update('jax_threefry_partitionable', old)


def _inputs(seed):
    """Edge-padded u8-valued images and per-image fold_in keys."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((len(HW), *CANVAS, 3), np.float32)
    for i, (h, w) in enumerate(HW):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        imgs[i] = np.pad(im, ((0, CANVAS[0] - h), (0, CANVAS[1] - w),
                              (0, 0)), mode='edge')
    key = jax.random.PRNGKey(seed)
    keys = np.asarray(jax.vmap(lambda j: jax.random.fold_in(key, j))(
        jnp.arange(len(HW))))
    return imgs, keys


def _check(noise, want, got):
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(want.astype(np.float64) - got)
    if noise in EXACT:
        np.testing.assert_array_equal(got, want)
    elif noise == 'gaussian_var0.1':
        assert d.max() <= 2.5e-7
    else:
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3


@pytest.mark.parametrize('noise', NOISES)
def test_masked_matches_jax(noise):
    jfn = jax_make_pipeline(noise, mode='TRAIN', use_pallas=True)
    fn = make_pipeline(noise, mode='TRAIN')
    assert fn.backend == jfn.backend.replace('pallas:', 'cuda:').replace(
        'xla', 'cuda:generic')
    imgs, keys = _inputs(len(noise))
    want = np.asarray(jfn.masked(jnp.asarray(keys), jnp.asarray(imgs),
                                 jnp.asarray(HW)))
    got = fn.masked(keys, torch.from_numpy(imgs), HW).numpy()
    _check(noise, want, got)
    # u8 input, as the solver passes the loader's batch
    got8 = fn.masked(keys, torch.from_numpy(imgs.astype(np.uint8)),
                     HW).numpy()
    np.testing.assert_array_equal(got8, got)


@pytest.mark.parametrize('noise', ['brownian_var0.09', 'periodic_var100',
                                   'quant_var7', 'bloom',
                                   'speckle_bilateral_var1.0',
                                   'sap_median_var0.4',
                                   'gaussian_gaus_blur_var0.1'])
def test_masked_at_full_extent(noise):
    """hw = the canvas: masked equals keyed bit for bit where the JAX
    package's does.  Where it does not, by the reference's design (quant
    fits on a subsample drawn from the valid region; periodic's step is a
    true division when n is data), the port's masked equals JAX's."""
    fn = make_pipeline(noise, mode='TRAIN')
    imgs, keys = _inputs(3)
    full = np.tile(np.int32(CANVAS), (len(HW), 1))
    x = torch.from_numpy(imgs)
    got = fn.masked(keys, x, full).numpy()
    if noise.startswith(('sap_median', 'gaussian_gaus_blur')):
        # the fused routes' masked is keyed in both packages
        # (pipeline.py:512-515, 562-565)
        np.testing.assert_array_equal(got, fn.keyed(keys, x).numpy())
        return
    jfn = jax_make_pipeline(noise, mode='TRAIN', use_pallas=True)
    j_masked = np.asarray(jfn.masked(jnp.asarray(keys), jnp.asarray(imgs),
                                     jnp.asarray(full)))
    j_keyed = np.asarray(jfn.keyed(jnp.asarray(keys), jnp.asarray(imgs)))
    if np.array_equal(j_masked, j_keyed):
        np.testing.assert_array_equal(got, fn.keyed(keys, x).numpy())
    else:
        assert noise in ('periodic_var100', 'quant_var7')
        _check(noise, j_masked, got)


def test_mix_masked_raises_naming_item_9():
    """The mix routes' masked, once refused naming ROADMAP item 9: a
    training batch (u8, as the solver passes the loader's batch) through
    the mix scan against the JAX package's run_masked, within the bounds
    of the kinds drawn (<= 1 on < 1e-3 of the elements)."""
    for noise in ('noise_mix_var_all', 'noise_mix_var_all_bilateral'):
        jfn = jax_make_pipeline(noise, mode='TRAIN', use_pallas=True)
        fn = make_pipeline(noise, mode='TRAIN')
        imgs, keys = _inputs(1)
        want = np.asarray(jfn.masked(jnp.asarray(keys), jnp.asarray(imgs),
                                     jnp.asarray(HW)))
        got = fn.masked(keys, torch.from_numpy(imgs.astype(np.uint8)),
                        HW).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        d = np.abs(want.astype(np.float64) - got)
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3, noise


def test_hw_on_a_device_refused():
    from tpudenoise_torch.noise import generators as G
    assert G._hw_rows(torch.tensor(HW), 3) == [tuple(r) for r in HW]
    with pytest.raises(ValueError):
        G._hw_rows(HW, 2)
