"""The port's Automold suite (`noise/automold.py`) and its HLS/HSV
conversions (`ops/color.py`) against the JAX package, on the CPU.

Images: the JAX test's fixture (seeded random 120x160 RGB with a filled
rectangle) for the cv2 bounds, and the same fixture at 123x157 (odd
extents: the autumn tiles and the blurs' edges) for the rest.  Every JAX
function runs under
`jax.jit` (XLA's CPU code contracts multiply-adds and turns a division by
a constant into a multiply; the port rounds where it does), and the two
draw from one key: the port's key ops give `jax.random`'s numbers.

Bounds, each with its reason (measured: every function bit-equal at
120x160, 123x157, 203x317 and 600x1000, and over all 2^24 RGB colours for
the conversions, of which the test takes every 17th):
* flips, channel orders and plane selections: bit-equal (no arithmetic);
* the conversions and the augmentations (float arithmetic, rounded to u8
  levels): at most FAR_SHARE = 1e-3 of the values more than one level
  off (a one-level change of L or H in an HLS round trip moves RGB by up
  to ~5) and at most NEAR_SHARE = 1e-2 off at all;
* against cv2, the JAX test's bounds (tests/test_automold.py:22-38): HLS
  within 1.5, more than 1 off on under 2% of the values; the HLS round
  trip within 6, more than 3 off on under 1% (cv2's 8-bit HSV rounds
  otherwise, and neither package holds its HSV to cv2)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import ast
import inspect

import cv2
import jax
import numpy as np
import pytest
import torch

from tpudenoise.noise import automold as J
from tpudenoise.ops import color as jcolor
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import automold as T
from tpudenoise_torch.ops import color as tcolor

FAR_SHARE = 1e-3
NEAR_SHARE = 1e-2


def _fixture(h=120, w=160):
    rng = np.random.RandomState(3)
    im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    cv2.rectangle(im, (30, 30), (90, 90), (40, 160, 90), -1)
    return im


IMG = _fixture()
ODD = _fixture(123, 157).astype(np.float32)


def _hold(got: torch.Tensor, want, exact=False):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.float64) - want)
    if exact:
        assert d.max() == 0, d.max()
    else:
        assert (d > 1).mean() <= FAR_SHARE, (d > 1).mean()
        assert (d > 0).mean() <= NEAR_SHARE, (d > 0).mean()


# -------------------------------------------------------- conversions --

def _colours():
    """Every 17th of the 2^24 RGB colours (17 is prime to 256: every level
    of each channel)."""
    a = np.arange(0, 256 ** 3, 17, dtype=np.int64)
    return np.stack([a >> 16, (a >> 8) & 255, a & 255], -1).astype(
        np.float32)


def _planes(n, seed=0):
    """n random (H, S|L, V|S) u8-domain triples, H in [0, 180)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, 180, n), rng.randint(0, 256, n),
                     rng.randint(0, 256, n)], -1).astype(np.float32)


@pytest.mark.parametrize('name', ['rgb_u8_to_hls_u8', 'rgb_u8_to_hsv_u8'])
def test_to_hls_hsv_match_jax_on_the_colour_cube(name):
    x = _colours()
    want = jax.jit(getattr(jcolor, name))(x)
    _hold(getattr(tcolor, name)(torch.from_numpy(x)), want)


@pytest.mark.parametrize('name', ['hls_u8_to_rgb_u8', 'hsv_u8_to_rgb_u8'])
def test_from_hls_hsv_match_jax(name):
    x = _planes(1_000_000)
    want = jax.jit(getattr(jcolor, name))(x)
    _hold(getattr(tcolor, name)(torch.from_numpy(x)), want)


def test_hls_matches_cv2():
    want = cv2.cvtColor(IMG, cv2.COLOR_RGB2HLS).astype(np.float32)
    got = tcolor.rgb_u8_to_hls_u8(torch.from_numpy(IMG.astype(np.float32)))
    d = np.abs(got.numpy() - want)
    assert d.max() <= 1.5 and (d > 1).mean() < 0.02


def test_hls_roundtrip():
    x = torch.from_numpy(IMG.astype(np.float32))
    back = tcolor.hls_u8_to_rgb_u8(tcolor.rgb_u8_to_hls_u8(x))
    d = np.abs(back.numpy() - IMG.astype(np.float32))
    assert d.max() <= 6.0 and (d > 3).mean() < 0.01


# ------------------------------------------------------ colour helpers --

HELPERS = [('hls', 'RGB'), ('hls', 'BGR'), ('hue', 'RGB'),
           ('lightness', 'BGR'), ('saturation', 'RGB'), ('hsv', 'RGB'),
           ('value', 'BGR'), ('bgr', 'RGB'), ('bgr', 'HLS'), ('bgr', 'HSV'),
           ('rgb', 'BGR'), ('rgb', 'hls'), ('rgb', 'HSV'), ('red', 'BGR'),
           ('green', 'RGB'), ('blue', 'BGR')]
NO_ARITHMETIC = {('bgr', 'RGB'), ('rgb', 'BGR'), ('red', 'BGR'),
                 ('green', 'RGB'), ('blue', 'BGR')}


@pytest.mark.parametrize('name,src', HELPERS)
def test_colour_helpers_match_jax(name, src):
    """One image and a list of two (the reference's list branch); an HLS
    or HSV source takes the planes of the image's own conversion."""
    x = IMG.astype(np.float32)
    if src.upper() == 'HLS':
        x = np.asarray(jcolor.rgb_u8_to_hls_u8(x))
    elif src.upper() == 'HSV':
        x = np.asarray(jcolor.rgb_u8_to_hsv_u8(x))
    want = jax.jit(lambda a: getattr(J, name)(a, src))(x)
    _hold(getattr(T, name)(torch.from_numpy(x), src), want,
          exact=(name, src) in NO_ARITHMETIC)
    outs = getattr(T, name)([torch.from_numpy(x)] * 2, src)
    assert isinstance(outs, list) and len(outs) == 2
    assert torch.equal(outs[1], getattr(T, name)(torch.from_numpy(x), src))


def test_unknown_source_space_raises():
    with pytest.raises(ValueError, match='unsupported source space LAB'):
        T.hue(torch.zeros(2, 2, 3), 'LAB')


# ------------------------------------------------------- augmentations --

AUGMENT = [
    ('change_light', lambda m, k, x: m.change_light(x, 1.3)),
    ('brighten', lambda m, k, x: m.brighten(k, x)),
    ('brighten 0.5', lambda m, k, x: m.brighten(k, x, 0.5)),
    ('darken', lambda m, k, x: m.darken(k, x)),
    ('darken 0.5', lambda m, k, x: m.darken(k, x, 0.5)),
    ('random_brightness', lambda m, k, x: m.random_brightness(k, x)),
    ('add_shadow', lambda m, k, x: m.add_shadow(k, x)),
    ('add_shadow 2x7', lambda m, k, x: m.add_shadow(k, x, 2, 7)),
    ('add_snow', lambda m, k, x: m.add_snow(k, x)),
    ('add_snow 0.8', lambda m, k, x: m.add_snow(k, x, 0.8)),
    ('add_rain', lambda m, k, x: m.add_rain(k, x)),
    ('add_rain drizzle', lambda m, k, x: m.add_rain(k, x,
                                                    rain_type='drizzle')),
    ('add_rain heavy', lambda m, k, x: m.add_rain(k, x, rain_type='heavy')),
    ('add_rain torrential', lambda m, k, x: m.add_rain(
        k, x, slant=5, drop_width=2, rain_type='torrential')),
    ('add_fog', lambda m, k, x: m.add_fog(k, x)),
    ('add_fog 0.8', lambda m, k, x: m.add_fog(k, x, 0.8, 16)),
    ('add_gravel', lambda m, k, x: m.add_gravel(k, x)),
    ('add_sun_flare', lambda m, k, x: m.add_sun_flare(k, x)),
    ('apply_motion_blur', lambda m, k, x: m.apply_motion_blur(x, 3)),
    ('add_speed', lambda m, k, x: m.add_speed(k, x)),
    ('add_speed 0.7', lambda m, k, x: m.add_speed(k, x, 0.7)),
    ('add_autumn', lambda m, k, x: m.add_autumn(k, x)),
    ('fliph', lambda m, k, x: m.fliph(x)),
    ('flipv', lambda m, k, x: m.flipv(x)),
    ('random_flip', lambda m, k, x: m.random_flip(k, x)),
    ('add_manhole', lambda m, k, x: m.add_manhole(k, x)),
    ('add_manhole at', lambda m, k, x: m.add_manhole(
        k, x, center=(60, 80), color=(10, 20, 30), height=9, width=30)),
    ('correct_exposure', lambda m, k, x: m.correct_exposure(x)),
]
FLIPS = {'fliph', 'flipv', 'random_flip'}


@pytest.mark.parametrize('name,fn', AUGMENT, ids=[a for a, _ in AUGMENT])
def test_augmentations_match_jax(name, fn):
    want = jax.jit(lambda k, a: fn(J, k, a))(jax.random.PRNGKey(11), ODD)
    got = fn(T, prng.PRNGKey(11), torch.from_numpy(ODD))
    _hold(got, want, exact=name in FLIPS)


def test_augment_random_matches_jax():
    """augment_random with the default list over the first keys whose
    draws pick every one of AUG_TYPES (the switch's every branch)."""
    assert T.AUG_TYPES == J.AUG_TYPES
    n = len(T.AUG_TYPES)
    seeds, picked = [], set()
    for seed in range(200):
        idx = int(prng.randint(prng.split(prng.PRNGKey(seed))[0], (), 0, n))
        if idx not in picked:
            picked.add(idx)
            seeds.append(seed)
    assert len(picked) == n
    jfn = jax.jit(J.augment_random)
    for seed in seeds:
        want = jfn(jax.random.PRNGKey(seed), ODD)
        got = T.augment_random(prng.PRNGKey(seed), torch.from_numpy(ODD))
        _hold(got, want)


def test_sun_flare_goes_down_the_bloom_route(monkeypatch):
    """add_sun_flare is the 'bloom' string's route: `bloom_batched` (kernel
    8 on a CUDA tensor) with `generators.bloom_params`, whose CPU version
    is `bloom_apply_scan`."""
    from tpudenoise_torch.noise import bloom
    from tpudenoise_torch.noise.generators import (bloom_apply_scan,
                                                   bloom_params)
    calls = []
    real = bloom.bloom_batched

    def spy(images, params):
        calls.append(tuple(images.shape))
        return real(images, params)

    monkeypatch.setattr(bloom, 'bloom_batched', spy)
    x = torch.from_numpy(IMG.astype(np.float32))
    key = prng.PRNGKey(5)
    got = T.add_sun_flare(key, x)
    assert calls == [(1, 120, 160, 3)]
    want = bloom_apply_scan(x[None], torch.from_numpy(
        bloom_params(key, 120, 160))[None])[0]
    assert torch.equal(got, want)


def _calls(tree, names) -> dict:
    """Count of calls to each dotted name in a module's syntax tree."""
    counts = dict.fromkeys(names, 0)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = ast.unparse(node.func)
            if name in counts:
                counts[name] += 1
    return counts


def test_key_ops_are_the_jax_modules():
    """The port's module draws with as many key ops of each kind as the
    JAX module: 5 randint, 7 split and 14 uniform."""
    port = _calls(ast.parse(inspect.getsource(T)),
                  ('prng.randint', 'prng.split', 'prng.uniform'))
    jax_ = _calls(ast.parse(inspect.getsource(J)),
                  ('jax.random.randint', 'jax.random.split',
                   'jax.random.uniform'))
    assert list(port.values()) == list(jax_.values()) == [5, 7, 14]


def test_public_functions_are_ported():
    public = {n for n, v in vars(J).items() if callable(v)
              and not n.startswith('_') and getattr(v, '__module__', '')
              == J.__name__}
    assert public <= set(dir(T)), public - set(dir(T))
