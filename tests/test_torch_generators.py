"""The port's threefry generators against the JAX package's on the CPU:
each kind through the reference's `_noisy_float` (the generator's float
output, where rounding shows) and through `apply_spec` (the u8-domain
image the pipeline passes on), plus the samplers directly.

Bounds, each with its reason (measured values in brackets):
* sap, uniform, poisson, periodic, quant, bloom, shader, original:
  bit-exact floats (integer hashing, exact uniforms, and every multiply-add
  rounded where XLA's CPU code rounds it; quant's map is a palette
  lookup);
* gaussian and speckle (normals through erf_inv), gamma (normals, log),
  rayleigh (log): XLA's CPU log1p and log are not correctly rounded, so a
  float can differ by an ulp or two: |diff| <= 5e-7 and >= 95% bit-equal
  [gaussian >= 99.5%, speckle >= 99.3%, gamma >= 99.8%, rayleigh >=
  96.1%]; after the u8 cast, a mod-256 distance <= 1 on <= 1e-3 of the
  elements [0];
* brownian: the port sums the exclusive prefix in a fixed log-step order,
  XLA in its own: <= 1 on < 1e-3 of the elements [<= 6.8e-4].
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.noise.fast_samplers as jfs
import tpudenoise.noise.pallas_bloom as pb
from tpudenoise.noise.pipeline import _noisy_float
from tpudenoise.noise.pipeline import apply_spec as japply_spec
from tpudenoise.noise.spec import Kind as JKind
from tpudenoise.noise.spec import NoiseSpec as JSpec
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import pipeline as tp
from tpudenoise_torch.noise import samplers
from tpudenoise_torch.noise.spec import Kind, NoiseSpec

EXACT = {Kind.ORIGINAL, Kind.SAP, Kind.UNIFORM, Kind.POISSON, Kind.PERIODIC,
         Kind.QUANT, Kind.BLOOM, Kind.SHADER}
SPECS = [(Kind.GAUSSIAN, 0.1), (Kind.GAUSSIAN, 1.5), (Kind.GAUSSIAN, -1.0),
         (Kind.POISSON, 0.0), (Kind.SAP, 0.4), (Kind.SPECKLE, 0.5),
         (Kind.SPECKLE, 2.0), (Kind.UNIFORM, 0.2), (Kind.UNIFORM, 1.2),
         (Kind.GAMMA, 0.05), (Kind.GAMMA, 0.2), (Kind.RAYLEIGH, 0.1),
         (Kind.RAYLEIGH, 0.3), (Kind.BROWNIAN, 0.9), (Kind.BROWNIAN, 0.009),
         (Kind.PERIODIC, 3.14159265358979), (Kind.PERIODIC, 100.0),
         (Kind.PERIODIC, -1.0), (Kind.QUANT, 3.0), (Kind.QUANT, 10.0),
         (Kind.BLOOM, 0.0), (Kind.SHADER, 0.0), (Kind.ORIGINAL, 0.0)]
SHAPES = [(2, 24, 40), (3, 17, 29)]


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    fn = pb.bloom_pallas
    pb.bloom_pallas = functools.partial(fn, interpret=True)
    yield
    pb.bloom_pallas = fn
    jax.config.update('jax_threefry_partitionable', old)


def _inputs(shape):
    img = np.random.RandomState(1).randint(0, 256, shape + (3,)).astype(
        np.float32)
    img[0] //= 3                      # poisson: 86 distinct values
    return img, prng.split(prng.PRNGKey(2), shape[0])


def _both(kind, lvl, shape, fn_jax, fn_port):
    img, keys = _inputs(shape)
    js = JSpec(JKind(int(kind)), level=float(lvl))
    ts = NoiseSpec(kind, level=float(lvl))
    want = np.asarray(jax.jit(jax.vmap(lambda k, im: fn_jax(js, k, im)))(
        jnp.asarray(keys), jnp.asarray(img)))
    got = fn_port(ts, keys, torch.from_numpy(img)).numpy()
    return want, got


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('kind,lvl', SPECS,
                         ids=[f'{k.name.lower()}{v:g}' for k, v in SPECS])
def test_generator_floats(kind, lvl, shape):
    want, got = _both(
        kind, lvl, shape,
        lambda s, k, im: _noisy_float(s, k, im, use_pallas=True)[0],
        lambda s, k, im: tp._noisy(s, k, im)[0])
    d = np.abs(want.astype(np.float64) - got)
    print(f'{kind.name} {lvl}: bit-equal {np.mean(d == 0):.5f}, max '
          f'{d.max():.3g}')
    assert got.dtype == np.float32 and got.shape == want.shape
    if kind in EXACT:
        np.testing.assert_array_equal(got, want)
    elif kind == Kind.BROWNIAN:
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    else:
        assert d.max() <= 5e-7 and np.mean(d == 0) >= 0.95


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('kind,lvl', SPECS,
                         ids=[f'{k.name.lower()}{v:g}' for k, v in SPECS])
def test_apply_spec_u8(kind, lvl, shape):
    want, got = _both(
        kind, lvl, shape,
        lambda s, k, im: japply_spec(s, k, im, use_pallas=True),
        tp.apply_spec)
    d = np.abs(want.astype(np.float64) - got)
    if kind in EXACT:
        np.testing.assert_array_equal(got, want)
    elif kind == Kind.BROWNIAN:
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    else:
        d = np.minimum(d, 256.0 - d)
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3


def test_poisson_sampler_over_lam_range():
    """Counts for lam in [0, 256) (inversion below 10, PTRS above): equal
    but for a rare acceptance-boundary flip, where another round's
    candidate is taken (<= 1e-3 of the draws; measured 1 in 18000)."""
    keys = prng.split(prng.PRNGKey(4), 3)
    lam = np.random.RandomState(5).uniform(0, 256, (3, 6000)).astype(
        np.float32)
    lam[:, :2000] /= 25.0
    want = np.asarray(jax.jit(jax.vmap(jfs.poisson_fixed))(
        jnp.asarray(keys), jnp.asarray(lam)))
    got = samplers.poisson_fixed(keys, torch.from_numpy(lam)).numpy()
    assert np.mean(got != want) <= 1e-3


def test_gamma_sampler_and_lgamma():
    keys = prng.split(prng.PRNGKey(6), 2)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jfs.gamma_fixed(k, 1.99, (8000,))))(jnp.asarray(keys)))
    got = samplers.gamma_fixed(keys, 1.99, 8000, 'cpu').numpy()
    d = np.abs(got - want)
    assert np.mean(d == 0) >= 0.99 and d.max() <= 1e-5 * max(1, want.max())
    z = np.linspace(0.5, 300.0, 5000, dtype=np.float32)
    np.testing.assert_allclose(
        samplers.stirling_lgamma(torch.from_numpy(z)).numpy(),
        np.asarray(jax.jit(jfs.stirling_lgamma)(jnp.asarray(z))), rtol=2e-6,
        atol=2e-6)
    with pytest.raises(ValueError):
        samplers.gamma_fixed(keys, 0.5, 10, 'cpu')
