"""`make_pipeline(..., use_kernels=False)` on the mixes against the JAX
package's `make_pipeline(..., use_pallas=False)` on the CPU (the
single-kind plans, the inputs and the forms: `test_torch_backend_xla.py`).

The port's route is the mix scan: per image `kc, ka = split(k)`, the entry
`randint(kc, (), 0, E)`, then the drawn template on `ka` with fast_rng
reaching every generator (the reference's `pipeline.py:248-258`); then
the plan's post-pass, a bilateral one through the bilateral kernel's
plain version (the JAX side's is its XLA chain).  `noise_mix_var_all`,
`_bilateral` and `_wavelet` share one table, so each package's plain mix
output of a form is the noise stage of the other two strings: the
post-passes are held stage by stage, on JAX's noise stage and on the
port's (a noise stage one level off in a pixel moves a bilateral or
wavelet output there by more than the post-pass's own bound).

Bounds (measured values in brackets, over both streams and all forms):
* the noise stage (the plain mix): a mod-256 distance <= 1 on <= 1e-3 of
  the elements, the generic route's bound for kinds through log, exp or
  erf_inv [5.4e-4];
* bilateral: the port's post-pass within 1 on < 1e-3 of the elements of
  JAX's XLA chain on the same input, JAX's noise stage and the port's
  (`tests/test_pallas_bilateral.py:17-23`), and the route's output that
  post-pass of the port's noise stage, bit for bit;
* wavelet: the port's post-pass on JAX's noise stage within 255 * 2e-5
  of JAX's floats before the cast (`tests/test_torch_wavelet.py`); the
  route's output within a mod-256 distance of 1 of JAX's post-pass of the
  port's noise stage, and only where JAX's float lies that near an
  integer (the cast turns an ulp there into a step of 1).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backend_xla import (HW, inputs, mod256, outputs,
                                          within_one)
from tpudenoise.denoise import stencils as JS
from tpudenoise.denoise import wavelet as JW
from tpudenoise.noise import generators as JG
from tpudenoise_torch.denoise import wavelet as W
from tpudenoise_torch.denoise.bilateral import bilateral_batched
from tpudenoise_torch.noise import generators as G
from tpudenoise_torch.noise.spec import parse

MIX = 'noise_mix_var_all'
WAVELET_ATOL = 255 * 2e-5


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


_jax_bilateral = jax.jit(jax.vmap(JS.bilateral))
_jax_wavelet = jax.jit(lambda x, hw: 255.0 * JW.denoise_wavelet_batched(
    JG.to_unit(x), hw=hw))


def _check_bilateral(jplain, plain, want, got):
    for stage, post in ((jplain, want),
                        (plain, np.asarray(_jax_bilateral(plain)))):
        d = np.abs(bilateral_batched(torch.from_numpy(stage.copy()))
                   .numpy() - post)
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    np.testing.assert_array_equal(bilateral_batched(torch.from_numpy(
        plain.copy())).numpy(), got)


def _check_wavelet(jplain, plain, want, got, hw):
    jf = np.asarray(_jax_wavelet(jplain, hw))
    np.testing.assert_array_equal(np.asarray(JG.wrap_cast_u8(jf)), want)
    tf = 255.0 * W.denoise_wavelet_batched(
        G.to_unit(torch.from_numpy(jplain.copy())), hw=hw).numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=WAVELET_ATOL)
    jf = np.asarray(_jax_wavelet(plain, hw))
    d = mod256(np.asarray(JG.wrap_cast_u8(jf)), got)
    frac = np.abs(jf - np.round(jf))
    assert d.max() <= 1 and (frac[d > 0] <= WAVELET_ATOL).all()


@pytest.mark.parametrize('fast', [False, True], ids=['threefry', 'fast_rng'])
def test_mixes_match_jax(fast):
    plans = {s: parse(s) for s in (MIX, MIX + '_bilateral', MIX + '_wavelet')}
    assert len({p.specs for p in plans.values()}) == 1
    raw, keys = inputs(11)
    outs = {s: outputs(s, fast, raw, keys) for s in plans}
    for form, (jplain, plain) in outs[MIX].items():
        print(f'{MIX} fast={fast} {form}: max '
              f'{mod256(jplain, plain).max():.3g}, changed '
              f'{np.mean(mod256(jplain, plain) > 0):.2e}')
        within_one(jplain, plain)
        _check_bilateral(jplain, plain, *outs[MIX + '_bilateral'][form])
        _check_wavelet(jplain, plain, *outs[MIX + '_wavelet'][form],
                       HW if form == 'masked' else None)
