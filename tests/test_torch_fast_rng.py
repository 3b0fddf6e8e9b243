"""`--fast-rng` in the port against the JAX package on the CPU: the
counter-hash stream per salt, each generator and both samplers with
`fast_bits`, and `make_pipeline(..., fast_rng=True)` on the generic and
bilateral routes, keyed and masked, against the JAX package's
(`use_pallas=True`, its Pallas bilateral in interpret mode).

Bounds, each with its reason (measured values in brackets):
* hash words and uniforms, every salt of the registry: bit-exact;
* Box-Muller normals: XLA's CPU log and cos are not correctly rounded,
  so a normal may differ by a few ulp: <= 4 ulp and >= 85% bit-equal
  [3 ulp, ~89%];
* samplers: poisson_fixed bit-exact over lam in [0, 600); gamma_fixed
  within 1e-6 relative [6.5e-7];
* generators: s&p, uniform and poisson bit-exact floats (uniforms, exact
  arithmetic, the multiply-adds rounded where XLA's CPU code rounds
  them); gaussian, speckle, gamma and rayleigh (normals or a log) within
  5e-7 and >= 95% bit-equal [<= 4.8e-7, >= 95.9%]; brownian (the port's
  fixed log-step prefix order, XLA's own) within 1 on < 1e-3 of the
  elements [4.5e-4];
* pipelines: the u8 outputs bit-exact on the routes whose draws are
  words or uniforms (s&p, poisson); the others within a
  mod-256 distance of 1 on <= 1e-3 of the elements, gaussian's [0, 1]
  floats within 2.5e-7;
* the fused routes (sap + median, gaussian + blur, the mixes) give the
  same bytes with and without the flag, as the reference's, which never
  passes it to them.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.pallas_bilateral as pbl
import tpudenoise.noise.fast_samplers as jfs
from tpudenoise.noise.pipeline import _noisy_float
from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
from tpudenoise.noise.spec import Kind as JKind
from tpudenoise.noise.spec import NoiseSpec as JSpec
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import pipeline as tp
from tpudenoise_torch.noise import samplers
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import Kind, NoiseSpec

# the reference's salt registry (`generators.py:52-60`): poisson 1, 8
# (and 9), 16-19; gamma 32-43; gaussian 64 (65); speckle 66 (67); uniform
# 68; rayleigh 69; s&p 70, 71; brownian 72 (73)
SALTS = (1, 8, 9, 16, 17, 18, 19, *range(32, 44), *range(64, 74))
NORMAL_SALTS = (8, 32, 35, 38, 41, 64, 66, 72)
EXACT = {Kind.SAP, Kind.UNIFORM, Kind.POISSON}
KINDS = [(Kind.GAUSSIAN, 0.1), (Kind.GAUSSIAN, -1.0), (Kind.POISSON, 0.0),
         (Kind.SAP, 0.4), (Kind.SPECKLE, 0.5), (Kind.UNIFORM, 1.2),
         (Kind.GAMMA, 0.2), (Kind.RAYLEIGH, 0.3), (Kind.BROWNIAN, 0.09)]
CANVAS = (24, 40)
HW = np.array([[24, 40], [19, 33], [24, 29]], np.int32)
# the routes at pipeline level (each generator's floats are held above):
# the bilateral route, words and uniforms (sap, poisson's PTRS), the raster
# of a bucketed canvas (brownian) and the [0, 1] floats of plain gaussian
PIPES = {'speckle_bilateral_var1.0': 'bilateral_x2',
         'sap_var0.4': 'generic', 'poisson': 'generic',
         'brownian_var0.09': 'generic', 'gaussian_var0.1': 'generic'}
PIPE_EXACT = {'sap_var0.4', 'poisson'}


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    saved = pbl.bilateral_pallas
    pbl.bilateral_pallas = functools.partial(saved, interpret=True)
    yield
    pbl.bilateral_pallas = saved
    jax.config.update('jax_threefry_partitionable', old)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def test_hash_stream_matches_jax_per_salt():
    keys = prng.split(prng.PRNGKey(5), 3)
    n = 4000

    def draws(k):
        seed = jfs._seed_from_key(k)
        return (jnp.stack([jfs._hash_words((n,), s, seed) for s in SALTS]),
                jnp.stack([jfs._u01((n,), s, seed) for s in SALTS]),
                jnp.stack([jfs._normal((n,), s, seed)
                           for s in NORMAL_SALTS]))

    words, u01, normal = (np.asarray(a) for a in jax.jit(jax.vmap(draws))(
        jnp.asarray(keys)))
    for i, s in enumerate(SALTS):
        np.testing.assert_array_equal(
            samplers._hash_words(keys, n, s, 'cpu').numpy().view(np.uint32),
            words[:, i])
        np.testing.assert_array_equal(
            samplers._u01(keys, n, s, 'cpu').numpy(), u01[:, i])
    for i, s in enumerate(NORMAL_SALTS):
        got = samplers._normal(keys, n, s, 'cpu').numpy()
        ulp = _ulps(got, normal[:, i])
        assert ulp.max() <= 4 and np.mean(ulp == 0) >= 0.85, (s, ulp.max())


def test_hash_plain_odd_sizes_and_seed_words():
    """The plain version's u32 arithmetic in int64 against numpy's
    wrapping uint32, for seed words with the top bit set, and the seed
    pair is the key's words [0] and [-1]."""
    seeds = np.array([[0xFFFFFFFF, 0x80000001], [7, 0xDEADBEEF]], np.uint32)
    n, salt = 1001, 43
    idx = np.arange(n, dtype=np.uint32)
    with np.errstate(over='ignore'):
        h = (idx * np.uint32(0x9E3779B9)
             ^ np.uint32(salt) * np.uint32(0x85EBCA6B)
             ^ seeds[:, :1] * np.uint32(0xC2B2AE35))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ seeds[:, 1:] * np.uint32(0x27D4EB2F)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x846CA68B)
        h = h ^ (h >> np.uint32(16))
    got = prng.draw_hash(seeds, n, salt, 'bits', 'cpu').numpy()
    np.testing.assert_array_equal(got.view(np.uint32), h)
    np.testing.assert_array_equal(prng.seed_from_key(seeds), seeds)
    with pytest.raises(ValueError):
        prng.hash_draw(torch.zeros((2, 3), dtype=torch.int64), 8, 1, 'u01')


@pytest.mark.parametrize('kind,lvl', KINDS,
                         ids=[f'{k.name.lower()}{v}' for k, v in KINDS])
def test_generators_with_fast_bits(kind, lvl):
    shape = (3, 17, 29)
    img = np.random.RandomState(1).randint(0, 256, shape + (3,)).astype(
        np.float32)
    img[0] //= 3                      # poisson: 86 distinct values
    keys = prng.split(prng.PRNGKey(2), shape[0])
    js = JSpec(JKind(int(kind)), level=float(lvl))
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, im: _noisy_float(js, k, im, fast_bits=True)[0]))(
        jnp.asarray(keys), jnp.asarray(img)))
    got = tp._noisy(NoiseSpec(kind, level=float(lvl)), keys,
                    torch.from_numpy(img), fast=True)[0].numpy()
    d = np.abs(want.astype(np.float64) - got)
    print(f'{kind.name} {lvl}: max {d.max():.3g}, equal {np.mean(d == 0):.4f}')
    if kind in EXACT:
        np.testing.assert_array_equal(got, want)
    elif kind == Kind.BROWNIAN:
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    else:
        assert d.max() <= 5e-7 and np.mean(d == 0) >= 0.95


def test_samplers_with_fast_bits():
    """poisson_fixed over lam in [0, 600) (inversion, PTRS and its
    fallback) bit-exact; gamma_fixed within 1e-6 relative (a normal's
    ulp grows threefold through v = (1 + c x)^3) [6.5e-7], >= 95%
    bit-equal."""
    keys = prng.split(prng.PRNGKey(4), 2)
    lam = np.concatenate([np.linspace(0, 12, 1500),
                          np.linspace(12, 600, 1500)]).astype(np.float32)
    lam = np.stack([lam, lam[::-1]])

    def jax_draws(k, la):
        return (jfs.poisson_fixed(k, la, fast_bits=True),
                jfs.gamma_fixed(k, 1.99, la.shape, fast_bits=True))

    wp, wg = (np.asarray(a) for a in jax.jit(jax.vmap(jax_draws))(
        jnp.asarray(keys), jnp.asarray(lam)))
    gp = samplers.poisson_fixed(keys, torch.from_numpy(lam), True).numpy()
    np.testing.assert_array_equal(gp, wp)
    gg = samplers.gamma_fixed(keys, 1.99, lam.shape[1], 'cpu', True).numpy()
    rel = np.abs(gg - wg) / np.maximum(np.abs(wg), 1e-6)
    assert rel.max() <= 1e-6 and np.mean(gg == wg) >= 0.95, rel.max()


def _inputs(seed):
    """Edge-padded u8-valued images and per-image fold_in keys."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((len(HW), *CANVAS, 3), np.float32)
    for i, (h, w) in enumerate(HW):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        imgs[i] = np.pad(im, ((0, CANVAS[0] - h), (0, CANVAS[1] - w),
                              (0, 0)), mode='edge')
    return imgs, prng.fold_in(prng.PRNGKey(seed), np.arange(len(HW)))


def _check(noise, want, got):
    assert got.shape == want.shape and got.dtype == np.float32
    if noise in PIPE_EXACT:
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(want.astype(np.float64) - got)
    if noise == 'gaussian_var0.1':
        assert d.max() <= 2.5e-7
        return
    d = np.minimum(d, 256.0 - d)
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (d.max(),
                                                     np.mean(d > 0))


@pytest.mark.parametrize('noise', sorted(PIPES))
def test_pipeline_fast_rng_matches_jax(noise):
    jfn = jax_make_pipeline(noise, mode='TRAIN', use_pallas=True,
                            fast_rng=True)
    fn = make_pipeline(noise, mode='TRAIN', fast_rng=True)
    assert fn.backend == f'cuda:{PIPES[noise]}+fast_rng'
    assert jfn.backend.endswith('+fast_rng')
    imgs, keys = _inputs(len(noise))
    x = torch.from_numpy(imgs)
    _check(noise, np.asarray(jfn.keyed(jnp.asarray(keys),
                                       jnp.asarray(imgs))),
           fn.keyed(keys, x).numpy())
    _check(noise, np.asarray(jfn.masked(jnp.asarray(keys),
                                        jnp.asarray(imgs),
                                        jnp.asarray(HW))),
           fn.masked(keys, x, HW).numpy())


@pytest.mark.parametrize('noise', ['sap_median_var0.4',
                                   'gaussian_gaus_blur_var0.1',
                                   'noise_mix_var_low',
                                   'noise_mix_var_all_bilateral'])
def test_fused_routes_ignore_fast_rng(noise):
    """The fused routes draw from their kernels' own coordinate hash: the
    flag changes neither their backend nor their bytes, keyed or
    masked (the mix scan)."""
    fast = make_pipeline(noise, fast_rng=True)
    slow = make_pipeline(noise)
    assert fast.backend == slow.backend and '+fast_rng' not in fast.backend
    imgs, keys = _inputs(7)
    x = torch.from_numpy(imgs)
    assert torch.equal(fast.keyed(keys, x), slow.keyed(keys, x))
    assert torch.equal(fast.masked(keys, x, HW), slow.masked(keys, x, HW))
