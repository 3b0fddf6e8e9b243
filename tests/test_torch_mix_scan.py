"""The port's mix scan (`noise/pipeline.py` `_group_specs`,
`_apply_specs_batched` over a mix table, the mix routes' `masked`)
against the JAX package's, on the CPU.

* `_group_specs`: the same templates, traced flags, entry -> template and
  entry levels as JAX's for every `noise_mix_var_*` table, TEST and
  TRAIN;
* the entry draw: per image `kc, ka = split(k)`, `randint(kc, (), 0, E)`,
  the template JAX's scan picks, and the kind the fused routes' prologue
  picks for the same key;
* `masked` on edge-padded (40, 56) canvases with per-image valid
  extents, against JAX's `run_masked` (its bilateral and bloom Pallas
  kernels in interpret mode), at the bounds of
  `tests/test_torch_mix.py`: a mod-256 distance <= 1 on <= 1e-3 of the
  elements; the wavelet post-pass in the stages of
  `tests/test_torch_wavelet.py` (its cast turns an ulp of a nearly
  integral 255 * w into a step of 1): the scan alone at that bound, the
  post-pass on JAX's scan within 255 * 2e-5 on the floats, and the whole
  route within a mod-256 distance of 1 that differs only where JAX's
  float lies that near an integer;
* grouping: the images that drew one template and level run as one
  batch, and each output equals that image's run alone, bit for bit;
* at full extent, `masked` equals `keyed` through the scan (the generic
  route), bit for bit for every image whose drawn kind is not quant or
  periodic, the two whose masked form differs by the reference's design
  (`tests/test_bucketed_noise.py:104`);
* a plan of several specs outside the fused kernels' reach takes the
  generic route through the scan, against JAX's XLA route.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.pallas_bilateral as pbl
import tpudenoise.noise.pallas_bloom as pb
import tpudenoise.noise.pallas_mix as pm
import tpudenoise.noise.pipeline as jpipe
from tpudenoise.noise import spec as jspec
from tpudenoise_torch.core import prng
from tpudenoise_torch.noise import pipeline as pipe
from tpudenoise_torch.noise.mix_prologue import mix_prologue, plan_tables
from tpudenoise_torch.noise.spec import TEST_MIX, Kind, parse

CANVAS = (40, 56)
HW = np.array([[31, 47], [40, 50], [25, 56], [40, 56], [33, 40],
               [20, 30]], np.int32)
TABLES = [f'noise_mix_{k}' for k in TEST_MIX]
DIFFERS_AT_FULL_EXTENT = {Kind.QUANT, Kind.PERIODIC}


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


def _inputs(seed, n=len(HW)):
    """Edge-padded u8-valued canvases and per-image fold_in keys."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, *CANVAS, 3), np.float32)
    for i, (h, w) in enumerate(HW[:n]):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        imgs[i] = np.pad(im, ((0, CANVAS[0] - h), (0, CANVAS[1] - w),
                              (0, 0)), mode='edge')
    keys = prng.fold_in(prng.PRNGKey(seed), np.arange(n) * 5 + 1)
    return imgs, keys


def _drawn(noise, mode, keys):
    """Each image's drawn template (after the pipeline's split)."""
    specs = parse(noise, mode=mode).specs
    templates, _, eb, el = pipe._group_specs(specs)
    ks = prng.split(keys, 1)[:, 0]
    kc = prng.split(ks)[:, 0]
    idx = prng.randint(kc, (), 0, len(specs))
    return [templates[eb[i]] for i in idx]


def _mod256(want, got):
    d = np.abs(want.astype(np.float64) - got)
    return np.minimum(d, 256.0 - d)


@pytest.mark.parametrize('mode', ['TEST', 'TRAIN'])
@pytest.mark.parametrize('noise', TABLES)
def test_group_specs_match_jax(noise, mode):
    specs = parse(noise, mode=mode).specs
    jspecs = jspec.parse(noise, mode=mode).specs
    t, f, eb, el = pipe._group_specs(specs)
    jt, jf, jeb, jel = jpipe._group_specs(jspecs)
    assert [(int(s.kind), s.level, int(s.denoise), s.unit_float_output)
            for s in t] == [(int(s.kind), s.level, int(s.denoise),
                             s.unit_float_output) for s in jt]
    assert f == jf
    np.testing.assert_array_equal(eb, jeb)
    np.testing.assert_array_equal(el, jel)
    assert el.dtype == jel.dtype == np.float32


@pytest.mark.parametrize('noise', TABLES)
def test_entry_draw_matches_jax_and_prologue(noise):
    specs = parse(noise, mode='TEST').specs
    templates, _, eb, _ = pipe._group_specs(specs)
    keys = prng.fold_in(prng.PRNGKey(11), np.arange(64))

    def draw(k):
        kc, _ = jax.random.split(k)
        return jax.random.randint(kc, (), 0, len(specs))

    jidx = np.asarray(jax.vmap(draw)(jnp.asarray(keys)))
    kc = prng.split(keys)[:, 0]
    idx = prng.randint(kc, (), 0, len(specs))
    np.testing.assert_array_equal(idx, jidx)
    kinds, peb, pel = plan_tables(specs)
    branch = mix_prologue(keys, torch.zeros((64, 8, 8, 3)), kinds, peb,
                          pel)[0].numpy()
    assert [int(templates[eb[i]].kind) for i in idx] == [
        kinds[b] for b in branch]


@pytest.mark.parametrize('noise,mode', [
    ('noise_mix_var_low', 'TRAIN'), ('noise_mix_var_all', 'TEST'),
    ('noise_mix_var_all_bilateral', 'TRAIN'),
    ('noise_mix_var_all_wavelet', 'TEST')])
def test_masked_matches_jax(noise, mode):
    imgs, keys = _inputs(len(noise) + len(mode))
    jfn = jpipe.make_pipeline(noise, mode=mode, use_pallas=True)
    fn = pipe.make_pipeline(noise, mode=mode)
    assert fn.backend == jfn.backend.replace('pallas:', 'cuda:')
    want = np.asarray(jfn.masked(jnp.asarray(keys), jnp.asarray(imgs),
                                 jnp.asarray(HW)))
    got = fn.masked(keys, torch.from_numpy(imgs), HW).numpy()
    d = _mod256(want, got)
    drawn = sorted({s.kind.name for s in _drawn(noise, mode, keys)})
    print(f'{noise} {mode}: kinds {drawn}, max {d.max()}, changed '
          f'{np.mean(d > 1e-6):.2e}')
    assert got.shape == want.shape and got.dtype == np.float32
    if noise.endswith('_wavelet'):
        _check_wavelet_stages(noise, mode, imgs, keys, want, got)
    else:
        assert d.max() <= 1 and np.mean(d > 1e-6) <= 1e-3
    # u8 input takes the same route
    np.testing.assert_array_equal(
        fn.masked(keys, torch.from_numpy(imgs.astype(np.uint8)), HW).numpy(),
        got)


def _check_wavelet_stages(noise, mode, imgs, keys, want, got):
    from tpudenoise.denoise import wavelet as JW
    from tpudenoise.noise import generators as JG
    from tpudenoise_torch.denoise import wavelet as W
    from tpudenoise_torch.noise import generators as G
    plan, jplan = parse(noise, mode=mode), jspec.parse(noise, mode=mode)
    first = pipe.make_pipeline(dataclasses.replace(
        plan, post_denoise=type(plan.post_denoise).NONE)).masked(
            keys, torch.from_numpy(imgs), HW).numpy()
    jfirst = np.asarray(jpipe.make_pipeline(dataclasses.replace(
        jplan, post_denoise=jspec.Denoise.NONE), use_pallas=True).masked(
            jnp.asarray(keys), jnp.asarray(imgs), jnp.asarray(HW)))
    d1 = _mod256(jfirst, first)
    assert d1.max() <= 1 and np.mean(d1 > 1e-6) <= 1e-3
    jf = np.asarray(jax.jit(lambda x, e: 255.0 * JW.denoise_wavelet_batched(
        JG.to_unit(x), hw=e))(jnp.asarray(jfirst), jnp.asarray(HW)))
    np.testing.assert_array_equal(np.asarray(JG.wrap_cast_u8(jf)), want)
    tf = 255.0 * W.denoise_wavelet_batched(G.to_unit(torch.from_numpy(
        np.array(jfirst))), hw=HW).numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=255 * 2e-5)
    d = _mod256(want, got)
    assert d.max() <= 1
    if not d1.any():
        frac = np.abs(jf - np.round(jf))
        assert (frac[d > 0] <= 255 * 2e-5).all()


def test_grouped_scan_equals_per_image():
    """Twelve images over the var_all table: the scan's batches of one
    template and level give each image what it gets alone."""
    specs = parse('noise_mix_var_all', mode='TEST').specs
    imgs, keys = _inputs(3)
    imgs = np.concatenate([imgs, imgs[::-1]])
    keys = prng.fold_in(prng.PRNGKey(2), np.arange(12))
    hw = np.concatenate([HW, HW[::-1]])
    x = torch.from_numpy(imgs)
    whole = pipe._apply_specs_batched(specs, keys, x, hw)
    drawn = _drawn('noise_mix_var_all', 'TEST', prng.fold_in(
        prng.PRNGKey(2), np.arange(12)))
    assert len({(s.kind, s.level) for s in drawn}) < 12
    for i in range(12):
        one = pipe._apply_specs_batched(specs, keys[i:i + 1], x[i:i + 1],
                                        hw[i:i + 1])
        np.testing.assert_array_equal(whole[i:i + 1].numpy(), one.numpy())


@pytest.mark.parametrize('noise', ['noise_mix_var_all',
                                   'noise_mix_var_high_bilateral'])
def test_masked_full_extent_equals_keyed_scan(noise):
    plan = parse(noise, mode='TRAIN')
    fn = pipe.make_pipeline(plan)
    scan = pipe._generic_pipeline(plan)
    assert scan.backend == 'cuda:generic'
    imgs, keys = _inputs(7)
    full = np.tile(np.int32(CANVAS), (len(HW), 1))
    x = torch.from_numpy(imgs)
    got = fn.masked(keys, x, full).numpy()
    want = scan.keyed(keys, x).numpy()
    kinds = [s.kind for s in _drawn(noise, 'TRAIN', keys)]
    same = [k not in DIFFERS_AT_FULL_EXTENT for k in kinds]
    assert sum(same) >= 3, kinds
    if plan.post_denoise == plan.specs[0].denoise:   # no post-pass
        np.testing.assert_array_equal(got[same], want[same])
    else:
        # the bilateral post-pass mixes the images' pixels with no
        # other image's, but the fused route's post-pass is the kernel's
        # and the generic route's the 3x3-stencil version's
        np.testing.assert_array_equal(
            got[same], pipe.bilateral_batched(
                torch.from_numpy(pipe._apply_specs_batched(
                    plan.specs, prng.split(keys, 1)[:, 0], x)
                    .numpy()[same])).numpy())


def test_several_specs_take_the_generic_route():
    """A mix whose entries carry their own denoise (no noise string
    gives one; the fused kernels do not cover it): the generic route,
    the scan and each drawn entry's median, against JAX's XLA route
    (masked; keyed is the same scan without hw)."""
    plan = parse('noise_mix_var_medium', mode='TEST')
    plan = dataclasses.replace(plan, specs=tuple(
        dataclasses.replace(s, denoise=type(s.denoise).MEDIAN)
        for s in plan.specs))
    jplan = jspec.parse('noise_mix_var_medium', mode='TEST')
    jplan = dataclasses.replace(jplan, specs=tuple(
        dataclasses.replace(s, denoise=jspec.Denoise.MEDIAN)
        for s in jplan.specs))
    fn = pipe.make_pipeline(plan)
    jfn = jpipe.make_pipeline(jplan, use_pallas=True)
    assert fn.backend == 'cuda:generic' and jfn.backend == 'xla'
    imgs, keys = _inputs(5)
    want = np.asarray(jfn.masked(jnp.asarray(keys), jnp.asarray(imgs),
                                 jnp.asarray(HW)))
    got = fn.masked(keys, torch.from_numpy(imgs), HW).numpy()
    d = _mod256(want, got)
    assert d.max() <= 1 and np.mean(d > 1e-6) <= 1e-3
