"""The port's bloom route against the JAX package's: `bloom_params`
bit-equal to `generators.bloom_params` (its f32 linspace included), the
plain compositing bit-equal to `bloom_pallas` in interpret mode and to
`generators.bloom_apply_scan`, and `make_pipeline('bloom')` against the
JAX generic route with `use_pallas=True`.  Bloom is selects, adds,
multiplies and a half-even round in one fixed order, so every comparison
is exact."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
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
    # the bucketed form: at full extent keyed; on a padded canvas the
    # JAX package's masked (the flare geometry follows the valid extent)
    full = np.tile(np.int32([130, 220]), (4, 1))
    np.testing.assert_array_equal(
        fn.masked(keys, torch.from_numpy(raw), full).numpy(), want)
    hw = np.int32([[130, 220], [100, 150], [64, 220], [130, 90]])
    np.testing.assert_array_equal(
        fn.masked(keys, torch.from_numpy(raw), hw).numpy(),
        np.asarray(jfn.masked(jkeys, jnp.asarray(raw, jnp.float32),
                              jnp.asarray(hw))))


def test_bloom_wrapper_rejects_bad_inputs():
    im = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        bloom_batched(im, torch.zeros((2, 47, 8)))
    with pytest.raises(TypeError):
        bloom_batched(im.to(torch.int16), torch.zeros((2, 48, 8)))
    with pytest.raises(ValueError):
        bloom_batched(im, torch.zeros((2, 48, 8), dtype=torch.float64))


# ---------------------------------------------- kernel 8's fast form --
#
# csrc/bloom_steps.cuh:composite_fast rounds with (x + 1.5 * 2^23) -
# 1.5 * 2^23, drops the clamp and the NaN test, and skips the blends of
# steps 0-7 where every pixel is in [+0, 255], every alpha in [+0, 1],
# step 8's alpha 1 and every colour in [+0, 255].  These tests pin what
# that rests on, in float32 on the CPU.

_ROUND = np.float32(12582912.0)     # 1.5 * 2^23


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _round_cases(name):
    f = np.float32
    if name == 'random':
        return np.random.RandomState(0).uniform(-600, 600, 2_000_000).astype(f)
    if name == 'half-integers':
        return np.arange(-1000, 1001).astype(f) * f(0.5)
    return np.asarray([2.0**22, -2.0**22, 2.0**23, -2.0**23, 3e38, -3e38,
                       np.inf, -np.inf, np.nan, -0.0, 0.0, -0.4, 0.4, 0.5,
                       -0.5, 254.5, 255.5, 255.49998, 1e-30, -1e-30], f)


@pytest.mark.parametrize('name', ['random', 'half-integers', 'edges'])
def test_magic_round_then_clamp_is_saturate(name):
    """clip((x + 1.5 * 2^23) - 1.5 * 2^23, 0, 255) equals clip(rint(x), 0,
    255) bit for bit in float32, NaN and signed zeros included."""
    x = _round_cases(name)
    with np.errstate(invalid='ignore', over='ignore'):
        got = np.clip((x + _ROUND) - _ROUND, np.float32(0), np.float32(255))
        want = np.clip(np.rint(x), np.float32(0), np.float32(255))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('hw', [(600, 1000), (24, 40), (1000, 600),
                                (375, 500)])
def test_bloom_params_allow_fast_form(hw):
    """Every alpha bloom_params yields lies in [+0, 1] and every colour in
    [+0, 255] (as the kernel tests them: on the bits, so -0.0 fails), and
    step 8's alpha is exactly 1, over 64 keys."""
    keys = prng.split(prng.PRNGKey(sum(hw)), 64)
    p = TG.bloom_params(keys, *hw)
    assert p.shape == (64, 48, 8)
    assert (_bits(p[..., 6]) <= _bits(1.0)).all()
    assert (_bits(p[..., 3:6]) <= _bits(255.0)).all()
    assert (_bits(p[:, 8, 6]) == _bits(1.0)).all()


def test_blend_of_in_range_values_stays_in_range():
    """alpha * overlay + (1 - alpha) * output, each op rounded to float32,
    for alpha in [0, 1] and values in [0, 255], lies in [+0, 255.5): so
    the fast form's rounding needs no clamp.  5M random triples plus the
    ends."""
    rng = np.random.RandomState(1)
    f = np.float32
    n = 5_000_000
    alpha = rng.uniform(0, 1, n).astype(f)
    alpha[:6] = [0.0, 1.0, 1e-30, np.nextafter(f(1), f(0)), 1e-8, 0.5]
    ov = rng.uniform(0, 255, n).astype(f)
    out = rng.randint(0, 256, n).astype(f)
    ov[::3] = np.round(ov[::3])
    ov[:6], out[:6] = 255.0, 255.0
    v = alpha * ov + (f(1) - alpha) * out
    assert v.dtype == np.float32
    assert (_bits(v) <= _bits(255.49998)).all()     # +0 .. below 255.5
    r = (v + _ROUND) - _ROUND
    np.testing.assert_array_equal(_bits(r), _bits(np.clip(np.rint(v), f(0),
                                                          f(255))))


def _fast_form(images, params):
    """composite_fast in torch float32 ops on the CPU: steps 0-7 move the
    overlay only, step 8 (alpha 1) outputs round(overlay), steps 9-47
    blend; rounding by the 1.5 * 2^23 adds, no clamp."""
    b, h, w, _ = images.shape
    yy = torch.arange(h, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32)[None, None, :]
    rnd = float(_ROUND)
    overlay = images.to(torch.float32)
    out = None
    for s in range(params.shape[1]):
        p = params[:, s]
        dx = xx - p[:, 0, None, None]
        dy = yy - p[:, 1, None, None]
        mask = (dx * dx + dy * dy) <= p[:, 2, None, None]
        overlay = torch.where(mask[..., None], p[:, None, None, 3:6], overlay)
        if s == 8:
            out = (overlay + rnd) - rnd
        elif s > 8:
            a = p[:, 6, None, None, None]
            out = ((a * overlay + (1.0 - a) * out) + rnd) - rnd
    return out


@pytest.mark.parametrize('dtype', ['u8', 'f32'])
def test_fast_form_matches_plain(dtype):
    """The fast form's algebra (no clamp, the 1.5 * 2^23 rounding, steps
    0-7 without blends) gives bloom_apply_scan's bits on in-range images
    with bloom_params' params."""
    rng = np.random.RandomState(9)
    imgs = rng.randint(0, 256, (4, 60, 140, 3)).astype(np.float32)
    if dtype == 'f32':          # non-integers inside [0, 255]
        imgs = np.clip(imgs + rng.uniform(-0.5, 0.5, imgs.shape), 0,
                       255).astype(np.float32)
    params = TG.bloom_params(prng.split(prng.PRNGKey(5), 4), 600, 1000)
    params[:, :8, 0] = [[5, 60, 120, 30, 90, 10, 100, 70]] * 4  # on-image
    params[:, :8, 1] = [[10, 40, 20, 55, 5, 30, 50, 25]] * 4
    params[:, 8, :2] = [[70, 30], [0, 0], [139, 59], [20, 50]]
    im, pr = torch.from_numpy(imgs), torch.from_numpy(params)
    got = _fast_form(im, pr).numpy()
    want = TG.bloom_apply_scan(im, pr).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
