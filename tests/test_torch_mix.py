"""The port's mixed-noise path against the JAX package's: the prologue,
the k-means fit, the plain versions of the mix kernels (JAX runs
`fused_mix_noise` / `fused_mix_bilateral` in interpret mode) and the two
pipelines, on the same seeded numpy inputs at tests/test_pallas_mix.py's
(24, 40) geometry.

Tolerances, each with its reason:
* integer and select-only kinds (original, sap, shader, bloom) and the
  draws of the prologue (branch, level, seeds, bloom params, poisson
  vals): bit-exact;
* kinds through log/exp/cos/sin (gaussian, poisson, speckle, uniform,
  gamma, rayleigh, periodic): XLA's CPU transcendentals are not torch's,
  and a last-ulp change can move a truncated u8 by one, so a mod-256
  distance <= 1 on <= 1% of the elements (gaussian's [0, 1] floats:
  within 1e-6); measured 0 on every kind but gaussian;
* brownian: the port scans the raster in another fixed order than the
  TPU kernel, so JAX's own bound against a flat cumsum
  (test_pallas_mix.py:153-162): < 1e-3 of the elements differ, by <= 1;
* quant: k-means centres within 2e-3 (the sums over 1024-point slices
  run in another order), and pixels within JAX's own near-tie bound,
  <= 2% of the pixels mapped to another palette colour;
* after the bilateral: |diff| <= 1 on <= 1% of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.noise.pallas_mix as pm
from tpudenoise.noise.spec import Kind, NoiseSpec, parse
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise import mix_prologue as mp

H, W = 24, 40
# one image per kind: (Kind, level), levels from the var_all table
ENTRIES = [(Kind(k), lvl) for k, lvl in
           [(0, 0.0), (1, 1.0), (2, 0.0), (3, 0.4), (4, 0.5), (5, 7.0),
            (6, 0.6), (7, 0.09), (8, 100.0), (9, 0.1), (10, 0.3),
            (11, 0.0), (12, 0.0)]]
EXACT = {Kind.ORIGINAL, Kind.SAP, Kind.SHADER, Kind.BLOOM}
TRANSCENDENTAL = {Kind.GAUSSIAN, Kind.POISSON, Kind.SPECKLE, Kind.UNIFORM,
                  Kind.GAMMA, Kind.RAYLEIGH, Kind.PERIODIC}


@pytest.fixture(scope='module', autouse=True)
def _partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    yield
    jax.config.update('jax_threefry_partitionable', old)


def to_port(jax_out, device='cpu'):
    """JAX prologue output (branch, level, seeds, vals, centers, bloom)
    as the port's kernel operands."""
    dtypes = (np.int32, np.float32, np.int32, np.float32, np.float32,
              np.float32)
    return [torch.from_numpy(np.asarray(a).astype(d)).to(device)
            for a, d in zip(jax_out, dtypes)]


@pytest.fixture(scope='module')
def per_kind():
    """Both kernels on both sides over a 13-image batch, one image per
    kind, fed the JAX prologue's scalars (each image's run alone with a
    one-entry table)."""
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (len(ENTRIES), H, W, 3)).astype(np.uint8)
    imgs[2] //= 4                       # poisson: 64 distinct values
    keys = jax.random.split(jax.random.PRNGKey(5), len(ENTRIES))
    parts = []
    for i, (kind, lvl) in enumerate(ENTRIES):
        kinds, eb, el = pm.plan_tables((NoiseSpec(kind, level=lvl),))
        parts.append([np.asarray(a) for a in pm.mix_prologue(
            keys[i:i + 1], jnp.asarray(imgs[i:i + 1]), kinds, eb, el)])
    params = [np.concatenate(p) for p in zip(*parts)]
    params[0] = np.asarray([int(k) for k, _ in ENTRIES], np.int32)
    kinds = tuple(range(13))
    jargs = [jnp.asarray(a) for a in params]
    jn = np.asarray(pm.fused_mix_noise(jnp.asarray(imgs), *jargs,
                                       kinds=kinds, interpret=True))
    jb = np.asarray(pm.fused_mix_bilateral(jnp.asarray(imgs), *jargs,
                                           kinds=kinds, interpret=True))
    targs = to_port(params)
    im = torch.from_numpy(imgs)
    tn = mk.fused_mix_noise(im, *targs, kinds).numpy()
    tb = mk.fused_mix_bilateral(im, *targs, kinds).numpy()
    return jn, tn, jb, tb


@pytest.mark.parametrize('i', range(len(ENTRIES)),
                         ids=[k.name.lower() for k, _ in ENTRIES])
def test_mix_noise_kind_matches_jax(per_kind, i):
    jn, tn = per_kind[0][i], per_kind[1][i]
    kind = ENTRIES[i][0]
    d = np.abs(jn - tn)
    print(f'{kind.name}: max |diff| {d.max()}, changed {np.mean(d > 0):.2e}')
    if kind in EXACT:
        np.testing.assert_array_equal(tn, jn)
    elif kind == Kind.GAUSSIAN:
        assert tn.min() >= 0 and tn.max() <= 1
        assert d.max() <= 1e-6
    elif kind in TRANSCENDENTAL:
        d = np.minimum(d, 256.0 - d)
        assert d.max() <= 1 and np.mean(d > 0) <= 0.01
    elif kind == Kind.BROWNIAN:
        assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    else:  # quant
        assert np.mean(np.any(jn != tn, -1)) <= 0.02


@pytest.mark.parametrize('i', range(len(ENTRIES)),
                         ids=[k.name.lower() for k, _ in ENTRIES])
def test_mix_bilateral_kind_matches_jax(per_kind, i):
    d = np.abs(per_kind[2][i] - per_kind[3][i])
    assert d.max() <= 1 and np.mean(d > 0) <= 0.01


def test_hash_and_u01_match_jax():
    rng = np.random.RandomState(5)
    ctr = rng.randint(0, 2**31 - 1, 256).astype(np.uint32)
    s0, s1 = 0x9E3779B9, 0x12345678
    for salt in (1, 16, 32, 64, 70, 72):
        want = np.asarray(pm._hash_ctr(jnp.asarray(ctr), salt,
                                       jnp.uint32(s0), jnp.uint32(s1)))
        got = mk.hash_ctr(torch.from_numpy(ctr.astype(np.int64)), salt, s0,
                          s1)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(
            mk.u01_bits(got).numpy(),
            np.asarray(pm._u01_bits(jnp.asarray(want))))


def _prologues(plan_or_specs, batch, h, w, seed, dim_poisson=True):
    specs = (parse(plan_or_specs).specs if isinstance(plan_or_specs, str)
             else plan_or_specs)
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (batch, h, w, 3)).astype(np.uint8)
    if dim_poisson:
        imgs[::2] //= 3                 # 86 distinct values: vals 128
    return _prologues_on(specs, imgs, seed)


def _prologues_on(specs, imgs, seed):
    """Both prologues on the same images and per-image keys."""
    kinds, eb, el = pm.plan_tables(specs)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(imgs))
    want = [np.asarray(a) for a in jax.jit(
        lambda k, im: pm.mix_prologue(k, im, kinds, eb, el))(
            keys, jnp.asarray(imgs))]
    got = [a.numpy() for a in mp.mix_prologue(
        np.asarray(keys), torch.from_numpy(imgs), kinds, eb, el)]
    return kinds, want, got


@pytest.mark.parametrize('plan', ['noise_mix_var_all', 'noise_mix_var_low',
                                  'noise_mix_var_high'])
def test_prologue_matches_jax(plan):
    """Entry draw, seeds, bloom params and poisson vals bit-equal; quant
    palettes within the centre tolerance."""
    kinds, want, got = _prologues(plan, 64, H, W, 11)
    assert mp.plan_tables(parse(plan).specs)[0] == kinds
    for name, a, b in zip(('branch', 'level', 'seeds', 'vals'), want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(got[5], want[5])
    drawn = {kinds[p] for p in got[0]}
    assert {int(Kind.QUANT), int(Kind.POISSON)} <= drawn
    assert set(np.unique(got[3])) > {1.0}
    np.testing.assert_allclose(got[4], want[4], atol=2e-3, rtol=0)


def test_prologue_subsampled_fit_matches_jax():
    """Images over 8192 pixels fit on an 8192-point subsample drawn on the
    host: palettes within the centre tolerance, BGR equal."""
    specs = (NoiseSpec(Kind.QUANT, level=10.0),
             NoiseSpec(Kind.QUANT, level=3.0), NoiseSpec(Kind.BLOOM))
    kinds, want, got = _prologues(specs, 4, 96, 100, 9, dim_poisson=False)
    assert (got[0] != kinds.index(int(Kind.BLOOM))).sum() >= 2
    np.testing.assert_allclose(got[4], want[4], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(got[4].reshape(4, 10, 6)[..., 3:],
                                  want[4].reshape(4, 10, 6)[..., 3:])
    np.testing.assert_array_equal(got[5], want[5])


def test_poisson_vals_at_powers_of_two():
    """vals = 2^ceil(log2(distinct count)) equal to the reference's where
    the count is itself a power of two (log2 exact or not, ceil must not
    step up) and one past it."""
    counts = (1, 2, 64, 127, 128, 129, 255, 256)
    rng = np.random.RandomState(12)
    imgs = np.empty((len(counts), H, W, 3), np.uint8)
    for i, n in enumerate(counts):
        imgs[i] = rng.permutation(np.resize(np.arange(n), H * W * 3)
                                  ).reshape(H, W, 3)
    kinds, want, got = _prologues_on((NoiseSpec(Kind.POISSON),), imgs, 4)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(
        got[3], np.float32([1, 2, 64, 128, 128, 256, 256, 256]))


def test_bilateral_plain_matches_pallas():
    """The body kernel 7 runs after the noise, as a plain function, against
    the standalone Pallas bilateral (same body) in interpret mode, on
    u8-domain floats with zero (BORDER_CONSTANT) edges: bit-exact."""
    from tpudenoise.denoise.pallas_bilateral import bilateral_pallas
    from tpudenoise_torch.denoise.bilateral import bilateral_plain
    imgs = np.random.RandomState(8).randint(0, 256, (2, H, W, 3)).astype(
        np.float32)
    imgs[1, :, :7] = 0.0
    want = np.asarray(bilateral_pallas(jnp.asarray(imgs), tile_h=16,
                                       interpret=True))
    got = bilateral_plain(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_fit_matches_jax():
    """kmeans_fit_traced_k on the same LAB points and key: first kk
    centres within 2e-3, inactive ones at their init."""
    from tpudenoise.noise.kmeans import kmeans_fit_traced_k as jfit
    from tpudenoise_torch.noise import kmeans as tk
    rng = np.random.RandomState(2)
    pts = rng.randint(0, 256, (960, 3)).astype(np.float32)
    for kk, seed in ((3, 1), (7, 2), (10, 3)):
        key = jax.random.PRNGKey(seed)
        want, wact = (np.asarray(a) for a in jfit(key, jnp.asarray(pts), kk))
        idx, first, gumbel = tk.fit_draws(np.asarray(key), len(pts))
        assert idx is None
        got, act = tk.kmeans_fit_traced_k(torch.from_numpy(pts), kk, first,
                                          torch.from_numpy(gumbel))
        np.testing.assert_array_equal(act.numpy(), wact)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_fixed_prologue_covers_entries():
    """The kernel checks' explicit-entry batch: image i gets entries[i]."""
    entries = [(Kind.QUANT, 3.0), (Kind.BLOOM, 0.0), (Kind.POISSON, 0.0),
               (Kind.GAMMA, 0.2)]
    im = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, H, W, 3)).astype(np.uint8))
    kinds, branch, level, seeds, vals, centers, bloom = mp.fixed_prologue(
        prng.split(prng.PRNGKey(1), 4), im, entries)
    assert [kinds[b] for b in branch.tolist()] == [int(k) for k, _ in
                                                  entries]
    np.testing.assert_array_equal(level.numpy(),
                                  np.float32([3.0, 0.0, 0.0, 0.2]))
    lab = centers[0].reshape(10, 6)[:, :3]
    assert (lab[3:] == 1e9).all() and (lab[:3] < 256).all()
    assert (centers[1:] == 0).all()
    assert bloom[1].any() and not bloom[[0, 2, 3]].any()
    assert vals[2] == 256.0 and vals[[0, 1, 3]].eq(1.0).all()


@pytest.fixture
def mix_interpret(monkeypatch):
    """The JAX mix kernels in interpret mode (the pipeline passes its own
    interpret flag, so the keyword is forced)."""
    for name in ('fused_mix_noise', 'fused_mix_bilateral'):
        fn = getattr(pm, name)
        monkeypatch.setattr(pm, name, (lambda f: lambda *a, **k: f(
            *a, **{**k, 'interpret': True}))(fn))


@pytest.mark.parametrize('noise', ['noise_mix_var_medium',
                                   'noise_mix_var_all_bilateral'])
def test_pipeline_keyed_matches_jax(mix_interpret, noise):
    from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
    from tpudenoise_torch.noise.pipeline import make_pipeline
    jfn = jax_make_pipeline(noise, mode='TEST', use_pallas=True)
    fn = make_pipeline(noise, mode='TEST')
    assert fn.backend == jfn.backend.replace('pallas:', 'cuda:')
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 256, (12, H, W, 3)).astype(np.uint8)
    idx = np.arange(12)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(3), i))(jnp.asarray(idx))
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), i) for i in idx])
    want = np.asarray(jfn.keyed(jkeys, jnp.asarray(raw, jnp.float32)))
    got = fn.keyed(keys, torch.from_numpy(raw)).numpy()
    # the same images as float32 take the same route (rounded to u8)
    np.testing.assert_array_equal(
        fn.keyed(keys, torch.from_numpy(raw.astype(np.float32))).numpy(), got)
    d = np.abs(want - got)
    print(f'{noise}: max |diff| {d.max()}, changed {np.mean(d > 0):.2e}')
    assert got.shape == want.shape and got.dtype == np.float32
    # per-image bounds of the drawn kinds: gaussian floats, brownian and
    # the bilateral differ only at rounding level
    assert d.max() <= 1 and np.mean(d > 1e-6) <= 1e-3
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fn.masked(keys, torch.from_numpy(raw), None)


def test_mix_routes_and_refusals():
    from tpudenoise_torch.noise.pipeline import make_pipeline
    assert make_pipeline('noise_mix_var_low').backend == 'cuda:fused_mix'
    assert (make_pipeline('noise_mix_var_high_bilateral').backend
            == 'cuda:fused_mix+bilateral')
    for noise, item in (('noise_mix_var_all_wavelet', 'item 10'),
                        ('noise_mix_var_all_median', 'item 3'),
                        ('curvelet', 'item 13')):
        with pytest.raises(NotImplementedError, match=item):
            make_pipeline(noise, mode='TRAIN')
    im = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    ops = mk.fused_mix_noise
    good = [torch.zeros(2, dtype=torch.int32), torch.zeros(2),
            torch.zeros((2, 2), dtype=torch.int32), torch.ones(2),
            torch.zeros((2, 60)), torch.zeros((2, 48, 8))]
    assert ops(im, *good, (0,)).shape == (2, 8, 8, 3)
    with pytest.raises(TypeError):
        ops(im.float(), *good, (0,))
    with pytest.raises(ValueError):
        ops(im, *good[:2], torch.zeros((2, 2)), *good[3:], (0,))
    with pytest.raises(ValueError):
        ops(im, *good, (0, 99))
