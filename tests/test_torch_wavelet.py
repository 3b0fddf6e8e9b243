"""The wavelet denoiser of the port (`tpudenoise_torch/denoise/wavelet.py`)
against the JAX package's, on the CPU, on numpy-seeded inputs.

Bounds, each with its reason:
* the DWT's coefficients and the denoised floats within 2e-5 absolute
  (the perfect-reconstruction budget of `tests/test_wavelet.py`: torch
  and XLA sum the band matmuls and the band variances in other orders);
* the sigma medians bit for bit (`_median_nonneg` selects order
  statistics and averages two of them in f32; both sides must give the
  same bits, duplicates spanning the middle included);
* the YCbCr pair within 4 ulp of 255 (XLA may contract a multiply into
  the add).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise.denoise import wavelet as JW
from tpudenoise.ops import color as JC
from tpudenoise_torch.denoise import wavelet as W
from tpudenoise_torch.ops import color as C

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ycbcr_pair_matches_jax():
    x = np.random.RandomState(0).rand(7, 9, 3).astype(np.float32) * 1.2 - .1
    want = np.asarray(jax.jit(JC.rgb01_to_ycbcr)(x))
    got = C.rgb01_to_ycbcr(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 255 * 2 ** -24)
    back = np.asarray(jax.jit(JC.ycbcr_to_rgb01)(want))
    np.testing.assert_allclose(C.ycbcr_to_rgb01(_t(want)).numpy(), back,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back, x, atol=1e-4)


@pytest.mark.parametrize('shape', [(64, 96), (101, 67), (37, 530)])
def test_dwt2_perfect_reconstruction_and_coefficients(shape):
    x = np.random.RandomState(1).randn(2, *shape).astype(np.float32)
    aa, d = W.dwt2(_t(x))
    np.testing.assert_allclose(W.idwt2(aa, d, shape).numpy(), x, atol=TOL)
    jaa, jd = jax.jit(JW.dwt2)(x)
    for got, want in zip((aa, *d), (jaa, *jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_wavedec2_multilevel_roundtrip():
    x = np.random.RandomState(2).randn(96, 600).astype(np.float32)
    a, coeffs, shapes = W.wavedec2(_t(x), 3)
    np.testing.assert_allclose(W.waverec2(a, coeffs, shapes).numpy(), x,
                               atol=5e-5)


def test_matrices_and_levels_are_the_reference_ones():
    for n in (37, 120, 320, 600):
        np.testing.assert_array_equal(W._analysis_matrix(n),
                                      JW._analysis_matrix(n))
        m = (n + W._L - 1) // 2
        np.testing.assert_array_equal(W._synthesis_matrix(m, n),
                                      JW._synthesis_matrix(m, n))
    for h, w in ((600, 1000), (64, 64), (240, 320), (37, 53)):
        assert W.default_levels(h, w) == JW.default_levels(h, w)


def test_matmul_flops_counts_the_blocks():
    """The bound's operation count, against a dense count by hand at a
    size where every application is one block."""
    h, w = 100, 120
    mh, mw = (h + 9) // 2, (w + 9) // 2
    dense = 2 * (h * 2 * mh * w + w * 2 * mw * 2 * mh
                 + 2 * mw * w * 2 * mh + 2 * mh * h * w)
    assert W.matmul_flops(3, h, w, levels=1) == 3 * dense
    # banded at 600x1000: fewer operations than dense
    assert W.matmul_flops(1, 600, 1000, 1) < 2 * (600 * 608 * 1000) * 2


def _median_rows():
    rng = np.random.RandomState(3)
    rows = []
    for n in (9, 10, 64, 65):
        r = np.abs(rng.randn(2, n)).astype(np.float32)
        rows.append(r)
        d = r.copy()                    # duplicates spanning the middle
        d[:, : n // 2 + 2] = d[0, 0]
        rows.append(d)
        q = np.round(r * 4) / 4         # many ties
        rows.append(q.astype(np.float32))
    return rows


@pytest.mark.parametrize('idx', range(12))
def test_median_bit_equal(idx):
    x = _median_rows()[idx]
    want = np.asarray(jax.jit(JW._median_nonneg)(x))
    got = W._median_nonneg(_t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, np.median(x, axis=1))


@pytest.mark.parametrize('idx', range(12))
def test_masked_median_bit_equal(idx):
    x = _median_rows()[idx]
    n = x.shape[1]
    rng = np.random.RandomState(idx)
    # rows with odd and even valid counts, duplicates kept in
    mask = np.zeros_like(x, bool)
    nv = np.array([n - 3, n - 2], np.int32)
    for r in range(2):
        mask[r, rng.permutation(n)[:nv[r]]] = True
    want = np.asarray(jax.jit(JW._median_nonneg_masked)(x, mask, nv))
    got = W._median_nonneg_masked(_t(x), _t(mask), _t(nv)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for r in range(2):
        assert got[r] == np.float32(np.median(x[r][mask[r]]))


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    clean = rng.rand(b, 1, 1, 3) * 0.6 + 0.2
    return np.clip(clean + rng.randn(b, h, w, 3) * 0.08, -0.1, 1.1
                   ).astype(np.float32)


@pytest.mark.parametrize('shape', [(37, 53), (120, 160), (240, 320)])
def test_denoise_wavelet_matches_jax(shape):
    img = _images(1, *shape, seed=shape[0])[0]
    want = np.asarray(JW.denoise_wavelet(img))
    got = W.denoise_wavelet(_t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    hw = np.array([shape[0] - 5, shape[1] - 7], np.int32)
    want = np.asarray(JW.denoise_wavelet(img, hw=jnp.asarray(hw)))
    got = W.denoise_wavelet(_t(img), hw=hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize('shape', [(37, 53), (120, 160)])
def test_denoise_wavelet_batched_matches_jax(shape):
    imgs = _images(3, *shape, seed=7)
    want = np.asarray(JW.denoise_wavelet_batched(imgs))
    got = W.denoise_wavelet_batched(_t(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # per-image statistics: the batch is each image alone
    one = W.denoise_wavelet(_t(imgs[1])).numpy()
    np.testing.assert_allclose(got[1], one, rtol=0, atol=TOL)
    hw = np.array([[shape[0], shape[1]], [shape[0] - 9, shape[1] - 4],
                   [shape[0] // 2 + 3, shape[1] - 11]], np.int32)
    want = np.asarray(JW.denoise_wavelet_batched(imgs, hw=jnp.asarray(hw)))
    got = W.denoise_wavelet_batched(_t(imgs), hw=hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# The wavelet routes of the noise pipeline against the JAX package's
# `make_pipeline(..., use_pallas=True)`.  Every `*_wavelet*` string of
# the TEST grammar denoises twice: the spec's wavelet (or the mix kernel)
# and then the plan's wavelet post-pass on the u8 result, and the second
# pass reconstructs its nearly smooth u8 input almost exactly (most of
# 255 * w lie within 1e-4 of an integer), where `wrap_cast_u8`'s
# truncation turns an ulp into a step of 1.  So each route is held in
# two stages:
# * the route without its post-pass: u8 outputs by their mod-256
#   distance, <= 1 on <= 1e-3 of the elements (as the generic and mix
#   routes' own tests hold them); quant: its palette's near ties map
#   <= 2% of the pixels to another colour (`test_torch_mix.py`'s bound),
#   and the wavelet spreads each over its support, so <= 2% of the
#   elements may differ, by any amount;
# * the post-pass on the JAX package's first stage: the port's floats
#   255 * w within 255 * 2e-5 of JAX's; on the gaussian routes the JAX
#   route's output is checked to be that post-pass of its first stage,
#   bit for bit (the other routes take the same `_post_batched_for`, and
#   a second compile of each would double their cost);
# * the whole route: mod-256 distance <= 1 everywhere (quant: but on <=
#   2% of the elements, as above), and where the first stages agree bit
#   for bit, an element may differ only where JAX's float lies within
#   255 * 2e-5 of an integer (the cast can go either way there).
ROUTES = ['gaussian_wavelet_var0.1', 'sap_wavelet_var0.4',
          'quant_wavelet_var7', 'noise_mix_var_all_wavelet']


def _mod256(want, got):
    d = np.abs(want.astype(np.float64) - got)
    return np.minimum(d, 256.0 - d)


@pytest.fixture
def jax_routes(monkeypatch):
    import tpudenoise.noise.pallas_mix as pm
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    for name in ('fused_mix_noise', 'fused_mix_bilateral'):
        fn = getattr(pm, name)
        monkeypatch.setattr(pm, name, (lambda f: lambda *a, **k: f(
            *a, **{**k, 'interpret': True}))(fn))
    yield
    jax.config.update('jax_threefry_partitionable', old)


def _without_post(plan):
    import dataclasses
    return dataclasses.replace(plan, post_denoise=type(plan.post_denoise)(0))


@pytest.mark.parametrize('noise', ROUTES + ['gaussian_wavelet_var0.1 masked'])
def test_wavelet_route_matches_jax(jax_routes, noise):
    from tpudenoise.noise import generators as JG
    from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
    from tpudenoise.noise.spec import parse as jax_parse
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise import generators as G
    from tpudenoise_torch.noise.pipeline import make_pipeline
    from tpudenoise_torch.noise.spec import Denoise, parse
    noise, _, form = noise.partition(' ')
    jplan, plan = jax_parse(noise, mode='TEST'), parse(noise, mode='TEST')
    assert plan.post_denoise == Denoise.WAVELET
    jfn = jax_make_pipeline(jplan, use_pallas=True)
    fn = make_pipeline(plan)
    assert fn.backend == jfn.backend.replace('pallas:', 'cuda:').replace(
        'xla', 'cuda:generic')
    jfirst_fn = jax_make_pipeline(_without_post(jplan), use_pallas=True)
    first_fn = make_pipeline(_without_post(plan))
    b, h, w = 4, 32, 44
    rng = np.random.RandomState(11)
    raw = (rng.rand(b, 1, 1, 3) * 120 + 60 + rng.randn(b, h, w, 3) * 25)
    raw = np.clip(raw, 0, 255).astype(np.uint8)
    idx = np.arange(b) * 5 + 1
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(4), i))(jnp.asarray(idx))
    keys = prng.fold_in(prng.PRNGKey(4), idx)
    jraw, traw = jnp.asarray(raw, jnp.float32), torch.from_numpy(raw)
    hw = None
    if form == 'masked':
        hw = np.array([[h, w], [h - 6, w - 9], [h - 13, w], [h // 2, w - 20]],
                      np.int32)
        run = lambda f, k, x: f.masked(k, x, hw)            # noqa: E731
        jrun = lambda f, k, x: f.masked(k, x, jnp.asarray(hw))  # noqa
    else:
        run = lambda f, k, x: f.keyed(k, x)                 # noqa: E731
        jrun = run
    got = run(fn, keys, traw)
    jfirst = np.asarray(jrun(jfirst_fn, jkeys, jraw))
    first = run(first_fn, keys, traw).numpy()
    # stage 1: the route without its post-pass
    d1 = _mod256(jfirst, first)
    quant = noise.startswith('quant')
    if quant:
        assert np.mean(d1 > 0) <= 0.02
    else:
        assert d1.max() <= 1 and np.mean(d1 > 0) <= 1e-3
    # stage 2: the post-pass on JAX's first stage
    jhw = None if hw is None else jnp.asarray(hw)
    jf = np.asarray(jax.jit(lambda x, e: 255.0 * JW.denoise_wavelet_batched(
        JG.to_unit(x), hw=e))(jnp.asarray(jfirst), jhw))
    want = np.asarray(JG.wrap_cast_u8(jf))
    if noise.startswith('gaussian'):
        np.testing.assert_array_equal(np.asarray(jrun(jfn, jkeys, jraw)),
                                      want)
    tf = 255.0 * W.denoise_wavelet_batched(G.to_unit(torch.from_numpy(
        jfirst)), hw=hw).numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=255 * TOL)
    # the whole route
    got = got.numpy()
    d = _mod256(want, got)
    frac = np.abs(jf - np.round(jf))
    print(f'{noise} {form}: first stage {np.mean(d1 > 0):.2e} changed; '
          f'route max {d.max():.3g}, changed {np.mean(d > 0):.2e}, by more '
          f'than 1 {np.mean(d > 1):.2e}; 255w within 1e-4 of an integer: '
          f'{np.mean(frac < 1e-4):.2f}')
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.mean(d > 1) <= 0.02 if quant else d.max() <= 1
    if not d1.any():
        assert (frac[d > 0] <= 255 * TOL).all()
