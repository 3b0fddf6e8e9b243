"""`make_pipeline(..., use_kernels=False)`, the reference's XLA route,
against the JAX package's `make_pipeline(..., use_pallas=False)` on the
CPU: single-kind plans here, the mixes in `test_torch_backend_xla_mix.py`.

Every plan takes the generic route (`_generic_pipeline`): sap + median and
gaussian + blur through the threefry generators and the 3x3 stencils
instead of their fused kernels, the bilateral stages through the
bilateral kernel's plain version (the JAX side runs its XLA chain), bloom
through the bloom kernel's (its XLA scan on the JAX side).  Three images
of 48x64 with the same keys, in the `run` (one key), `keyed` (per-image
fold_in keys) and `masked` (per-image valid extents) forms, with
`fast_rng` off and on; `.backend` must be the JAX route's, 'xla' or
'xla+fast_rng'.

Bounds, as `tests/test_torch_generic_route.py` and
`tests/test_torch_fast_rng.py` set them (measured values in brackets):
* sap + median (uniform draws, integer stencils) and bloom (kernel 8 is
  bit-equal to the XLA scan, `tests/test_pallas.py:187-203`): bit-exact;
* gaussian + blur (normals through erf_inv, or the hash's Box-Muller): a
  mod-256 distance <= 1 on <= 1e-3 of the elements [0];
* speckle + bilateral: the bilateral kernel's plain version lies within
  1 on < 1e-3 of the XLA chain's pixels
  (`tests/test_pallas_bilateral.py:17-23`), and fast_rng's normals within
  1 on <= 1e-3: within 1 on <= 1e-3 [3.6e-5, 7.2e-5].
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise.pipeline import make_pipeline

SHAPE = (3, 48, 64)
HW = np.array([[48, 64], [40, 57], [33, 64]], np.int32)


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


def inputs(seed: int):
    """u8-valued float32 images and per-image fold_in keys."""
    raw = np.random.RandomState(seed).randint(0, 256, SHAPE + (3,)).astype(
        np.float32)
    return raw, prng.fold_in(prng.PRNGKey(3), np.arange(SHAPE[0]) * 7 + 2)


def outputs(noise: str, fast: bool, raw, keys):
    """{form: (JAX's output, the port's)} of one noise string."""
    jfn = jax_make_pipeline(noise, use_pallas=False, fast_rng=fast)
    fn = make_pipeline(noise, use_kernels=False, fast_rng=fast)
    assert fn.backend == jfn.backend == ('xla+fast_rng' if fast else 'xla')
    x, jx, jk = torch.from_numpy(raw), jnp.asarray(raw), jnp.asarray(keys)
    return {
        'run': (np.asarray(jfn(jax.random.PRNGKey(8), jx)),
                fn(prng.PRNGKey(8), x).numpy()),
        'keyed': (np.asarray(jfn.keyed(jk, jx)), fn.keyed(keys, x).numpy()),
        'masked': (np.asarray(jfn.masked(jk, jx, jnp.asarray(HW))),
                   fn.masked(keys, x, HW).numpy())}


def mod256(want, got):
    d = np.abs(want.astype(np.float64) - got)
    return np.minimum(d, 256.0 - d)


def within_one(want, got):
    """A mod-256 distance <= 1 on <= 1e-3 of the elements."""
    d = mod256(want, got)
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (d.max(), np.mean(d > 0))


@pytest.mark.parametrize('fast', [False, True], ids=['threefry', 'fast_rng'])
@pytest.mark.parametrize('noise', ['sap_median_var0.4',
                                   'gaussian_gaus_blur_var0.1',
                                   'speckle_bilateral_var1.0', 'bloom'])
def test_single_kind_matches_jax(noise, fast):
    raw, keys = inputs(len(noise))
    exact = noise in ('sap_median_var0.4', 'bloom')
    for form, (want, got) in outputs(noise, fast, raw, keys).items():
        assert got.shape == want.shape and got.dtype == np.float32, form
        print(f'{noise} fast={fast} {form}: max '
              f'{mod256(want, got).max():.3g}')
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=form)
        else:
            within_one(want, got)


def test_default_routes_unchanged():
    """use_kernels None and True keep the kernel routes; False is the XLA
    route for every plan, whatever the default would take."""
    for noise, route in (('sap_median_var0.4', 'cuda:sap_median'),
                         ('gaussian_gaus_blur_var0.1', 'cuda:gaussian_blur'),
                         ('speckle_bilateral_var1.0', 'cuda:bilateral_x2'),
                         ('noise_mix_var_all', 'cuda:fused_mix'),
                         ('noise_mix_var_all_bilateral',
                          'cuda:fused_mix+bilateral'),
                         ('bloom', 'cuda:generic')):
        assert make_pipeline(noise).backend == route
        assert make_pipeline(noise, use_kernels=True).backend == route
        assert make_pipeline(noise, use_kernels=False).backend == 'xla'
        assert make_pipeline(noise, use_kernels=False,
                             fast_rng=True).backend == 'xla+fast_rng'
