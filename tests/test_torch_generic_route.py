"""The port's single-kind generic route (threefry generators, stencils,
and the bilateral route's kernel passes) against the JAX package's
`make_pipeline(..., use_pallas=True)` on the CPU, whose `bilateral_pallas`
and `bloom_pallas` run in interpret mode: `.keyed` with per-image
fold_in keys and `__call__` with one key, at 2x24x40 and 3x17x29.

Bounds, each with its reason (measured values in brackets):
* integer paths and the stencils (sap, uniform + mean, periodic, quant),
  and the bilateral stages: bit-exact;
* kinds through log, exp or erf_inv (speckle, poisson, gamma, rayleigh,
  and gaussian before the bilateral): a mod-256 distance <= 1 on <= 1e-3
  of the elements [0];
* brownian: the prefix sums in another fixed order, <= 1 on < 1e-3 of the
  elements [<= 1.7e-4];
* gaussian_var0.1's [0, 1] floats (a reference quirk): within 2.5e-7
  [6e-8, the erf_inv's last ulp].
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools
import os.path as osp
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.pallas_bilateral as pbl
import tpudenoise.noise.pallas_bloom as pb
from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise.pipeline import make_pipeline

NOISES = ['speckle_bilateral_var1.0', 'uniform_mean_var0.6', 'poisson',
          'gamma_var0.1', 'rayleigh_var0.2', 'brownian_var0.09',
          'periodic_var100', 'quant_var7', 'sap_var0.4', 'gaussian_var0.1',
          'gaussian_bilateral_var1.0']
EXACT = {'uniform_mean_var0.6', 'periodic_var100', 'quant_var7',
         'sap_var0.4', 'speckle_bilateral_var1.0',
         'gaussian_bilateral_var1.0'}
SHAPES = [(2, 24, 40), (3, 17, 29)]
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


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


def _check(noise, want, got):
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(want.astype(np.float64) - got)
    print(f'{noise}: max {d.max():.3g}, changed {np.mean(d > 0):.2e}')
    if noise in EXACT:
        np.testing.assert_array_equal(got, want)
    elif noise == 'gaussian_var0.1':
        assert got.min() >= 0 and got.max() <= 1 and d.max() <= 2.5e-7
    elif noise.startswith('brownian'):
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    else:
        d = np.minimum(d, 256.0 - d)
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('noise', NOISES)
def test_route_matches_jax(noise, shape):
    jfn = jax_make_pipeline(noise, mode='TEST', use_pallas=True)
    fn = make_pipeline(noise, mode='TEST')
    want_backend = jfn.backend.replace('pallas:', 'cuda:')
    assert fn.backend == want_backend.replace('xla', 'cuda:generic')
    raw = np.random.RandomState(sum(shape)).randint(
        0, 256, shape + (3,)).astype(np.uint8)
    idx = np.arange(shape[0]) * 7 + 2
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(3), i))(jnp.asarray(idx))
    keys = prng.fold_in(prng.PRNGKey(3), idx)
    want = np.asarray(jfn.keyed(jkeys, jnp.asarray(raw, jnp.float32)))
    got = fn.keyed(keys, torch.from_numpy(raw)).numpy()
    _check(noise, want, got)
    # u8 or u8-domain float32 input: the same images, the same output
    np.testing.assert_array_equal(
        fn.keyed(keys, torch.from_numpy(raw.astype(np.float32))).numpy(), got)
    want1 = np.asarray(jfn(jax.random.PRNGKey(8),
                           jnp.asarray(raw, jnp.float32)))
    _check(noise, want1, fn(prng.PRNGKey(8), torch.from_numpy(raw)).numpy())
    # the bucketed form at full extent: keyed, but where the reference's
    # masked differs by design (periodic's step a true division, quant's
    # fit subsample drawn from the valid region): the JAX package's masked
    full = np.tile(np.int32(shape[1:]), (shape[0], 1))
    got_m = fn.masked(keys, torch.from_numpy(raw), full).numpy()
    if noise in ('periodic_var100', 'quant_var7'):
        _check(noise, np.asarray(jfn.masked(jkeys, jnp.asarray(
            raw, jnp.float32), jnp.asarray(full))), got_m)
    else:
        np.testing.assert_array_equal(got_m, got)


def test_every_single_kind_results_string_builds():
    """Every single-kind row of RESULTS.md builds (the wavelet one too),
    and each backend is the reference's own route."""
    with open(osp.join(REPO, 'RESULTS.md')) as f:
        rows = set(re.findall(r'^\| ([a-z0-9_.]+)(?: \(control[^|]*\))? \|',
                              f.read(), re.M)) - {'noise'}
    single = sorted(r for r in rows if 'mix' not in r)
    assert len(single) == 37
    for noise in single:
        jfn = jax_make_pipeline(noise, mode='TEST', use_pallas=True)
        assert make_pipeline(noise).backend == jfn.backend.replace(
            'pallas:', 'cuda:').replace('xla', 'cuda:generic'), noise


def test_detect_chunk_through_the_bilateral_route():
    """A small eval chunk for speckle_bilateral_var1.0: the port's noise
    stage equals the JAX pipeline's, so the chunk's detections equal those
    of the same chunk fed the JAX noise."""
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.eval.harness import detect_chunk
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    noise = 'speckle_bilateral_var1.0'
    cfg = default_config()
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 128, 32
    model = FasterRCNN('vgg16', num_classes=3, cfg=cfg, dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    raw = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 40, 56, 3)).astype(np.uint8))
    geom = torch.tensor([[40, 56, 40, 56, 1.0]] * 2)
    jfn = jax_make_pipeline(noise, mode='TEST', use_pallas=True)

    class JaxNoise:
        def keyed(self, keys, images):
            return torch.from_numpy(np.array(jfn.keyed(
                jnp.asarray(keys), jnp.asarray(images.numpy(), jnp.float32))))

    outs = [detect_chunk(model, params, prng.PRNGKey(3), [0, 5], raw,
                         [(geom, (48, 64))], fn)
            for fn in (make_pipeline(noise), JaxNoise())]
    for a, b in zip(*outs):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert outs[0][2].any()
