"""The stage-cut sap + median kernels (the profiling forks of kernel 1)
against the reference's profiling scripts, bit for bit.

`benchmarks/profile_sap_breakdown.py` (`run`, `_u8_run_jit`) and
`benchmarks/profile_fused.py` (`kernel_only`) are loaded by path and run
their Pallas kernels in interpret mode on the CPU; the port's entry points
run `sap_stages_plain`, which the CUDA kernels are held to on the card.
Every stage is min/max and integer hashing, so nothing may differ, at two
tile heights, with h not a multiple of the tile height and the raster's
pad lanes present (w3 = 120, w3p = 128), and at the walk's edge shapes
(h <= 3, w3 = 3)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import importlib.util
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpudenoise_torch.benchmarks import profile_fused as tpf
from tpudenoise_torch.benchmarks import profile_sap_breakdown as tpsb
from tpudenoise_torch.noise import fused_kernels as fk

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
STAGES = ('copy', 'noise', 'med1', 'full')


def _load(name):
    spec = importlib.util.spec_from_file_location(
        'ref_' + name, osp.join(REPO, 'benchmarks', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def ref_breakdown():
    return _load('profile_sap_breakdown')


@pytest.fixture(scope='module')
def images():
    rng = np.random.RandomState(7)
    return (rng.randint(0, 256, (2, 20, 40, 3)).astype(np.float32),
            np.asarray([5, 2**31 - 9], np.int32))


@pytest.mark.parametrize('tile_h', [8, 16])
@pytest.mark.parametrize('stage', STAGES)
def test_f32_stage_matches_reference(ref_breakdown, images, tile_h, stage):
    img, seeds = images
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_breakdown.run(jnp.asarray(img),
                                            jnp.asarray(seeds), tile_h,
                                            stage))
    got = tpsb.run(torch.from_numpy(img), torch.from_numpy(seeds), tile_h,
                   stage)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('tile_h', [8, 16])
@pytest.mark.parametrize('stage', STAGES)
def test_u8_stage_matches_reference(ref_breakdown, images, tile_h, stage):
    img, seeds = images
    img = img.astype(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_breakdown._u8_run_jit(
            jnp.asarray(img), jnp.asarray(seeds), tile_h, stage))
    got = tpsb.u8_run(torch.from_numpy(img), torch.from_numpy(seeds),
                      tile_h, stage)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)



# (B, h, w, tile height): h <= 3 (one tile of 8, and one of 56: hp - h of
# several walk steps) and w3 = 3 (W = 1: 125 pad lanes)
EDGE_SHAPES = {'h 1': (2, 1, 5, 8), 'h 2': (1, 2, 7, 8),
               'h 3, w3 3': (2, 3, 1, 8),
               'h 3, tile 56': (1, 3, 4, 56), 'h 7, w3 3': (1, 7, 1, 8)}


def _edge_images(name):
    b, h, w, tile_h = EDGE_SHAPES[name]
    rng = np.random.RandomState(b + 10 * h + 100 * w)
    return (rng.randint(0, 256, (b, h, w, 3)).astype(np.float32),
            rng.randint(-2**31, 2**31 - 1, b).astype(np.int32), tile_h)


@pytest.mark.parametrize('stage', STAGES)
@pytest.mark.parametrize('dtype', ['f32', 'u8'])
@pytest.mark.parametrize('shape', list(EDGE_SHAPES))
def test_edge_shape_stage_matches_reference(ref_breakdown, shape, dtype,
                                            stage):
    """`run` and `u8_run` against the reference's `run` and `_u8_run_jit`
    at the walk's edge shapes."""
    img, seeds, tile_h = _edge_images(shape)
    ref, port = ((ref_breakdown.run, tpsb.run) if dtype == 'f32'
                 else (ref_breakdown._u8_run_jit, tpsb.u8_run))
    if dtype == 'u8':
        img = img.astype(np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref(jnp.asarray(img), jnp.asarray(seeds), tile_h,
                              stage))
    got = port(torch.from_numpy(img), torch.from_numpy(seeds), tile_h, stage)
    assert got.dtype == (torch.float32 if dtype == 'f32' else torch.uint8)
    np.testing.assert_array_equal(got.numpy(), want)

def test_full_stage_is_the_eval_noise(images):
    """The full stage on the edge-padded raster is kernel 1's output."""
    img, seeds = images
    x, s = torch.from_numpy(img), torch.from_numpy(seeds)
    for tile_h in (8, 16):
        assert torch.equal(tpsb.run(x, s, tile_h, 'full'),
                           fk.fused_sap_median_plain(x, s, 0.4, True))
    assert torch.equal(tpsb.run(x, s, 8, 'med1'),
                       fk.fused_sap_median_plain(x, s, 0.4, False))


@pytest.mark.parametrize('tile_h', [8, 16])
def test_kernel_only_matches_reference(monkeypatch, tile_h):
    """The whole (B, hp, w3p) output, pad rows and pad lanes computed from
    the random raster there, equals the reference's kernel_only."""
    ref = _load('profile_fused')
    captured = []
    for mod in (ref, tpf):
        monkeypatch.setattr(mod, 'B', 2)
        monkeypatch.setattr(mod, 'H', 20)
        monkeypatch.setattr(mod, 'W', 40)
    monkeypatch.setattr(ref, 'timeit',
                        lambda fn, *a, **k: captured.append(fn(*a)))
    with pltpu.force_tpu_interpret_mode():
        ref.kernel_only(tile_h)
    want = np.asarray(captured[0])
    got = tpf.kernel_only_output(tile_h, device='cpu')
    assert got.shape == want.shape == (2, -(-20 // tile_h) * tile_h, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    raster, _ = tpf.padded_raster(tile_h, 'cpu')
    # the raster holds other values than the image edge in its pad lanes
    assert not torch.equal(raster[:, :, 120:], raster[:, :, 119:120].expand(
        -1, -1, 8))


def test_wrappers_refuse_bad_input():
    raster = torch.zeros(2, 32, 128)
    seeds = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match='stage'):
        fk.sap_stages(raster, seeds, 20, 120, 'blur')
    with pytest.raises(ValueError, match='fit'):
        fk.sap_stages(raster, seeds, 30, 120, 'full')
    with pytest.raises(TypeError, match='float32'):
        fk.sap_full_padded(raster.to(torch.uint8), seeds, 20, 120)
    with pytest.raises(ValueError, match='int32'):
        fk.sap_stages(raster, seeds.long(), 20, 120, 'copy')
    with pytest.raises(ValueError, match='device'):
        fk.sap_stages(raster.to('meta'), seeds.to('meta'), 20, 120, 'copy')


def test_stage_outputs_and_launch_counts_on_cpu():
    """Each stage adds one element-wise step to the previous one; the CPU
    path launches nothing."""
    rng = np.random.RandomState(1)
    raster = torch.from_numpy(rng.randint(0, 256, (1, 32, 128)).astype(
        np.float32))
    seeds = torch.tensor([3], dtype=torch.int32)
    before = dict(fk.launches)
    out = {s: fk.sap_stages(raster, seeds, 20, 120, s) for s in STAGES}
    assert fk.launches == before
    assert torch.equal(out['copy'], raster[:, 4:28])
    flipped = out['noise'] != out['copy']
    assert 0.3 < flipped.double().mean() < 0.5
    assert set(out['noise'][flipped].unique().tolist()) <= {0.0, 255.0}
    assert not torch.equal(out['med1'], out['full'])


def test_full_padded_is_the_f32_full_stage():
    rng = np.random.RandomState(4)
    raster = torch.from_numpy(rng.randint(0, 256, (2, 32, 128)).astype(
        np.float32))
    seeds = torch.tensor([3, 9], dtype=torch.int32)
    assert torch.equal(fk.sap_full_padded(raster, seeds, 20, 120, 0.7),
                       fk.sap_stages(raster, seeds, 20, 120, 'full', 0.7))


@pytest.mark.parametrize('entry', ['bench', 'timeit'])
def test_images_per_s_counts_the_given_batch(monkeypatch, entry):
    """Both entries divide by the batch they were given (not the scripts'
    default of 128), and call fn with seeds that change every call."""
    from tpudenoise_torch.benchmarks import timing

    def one_second(calls, device):
        for c in calls:
            c()
        return 1000.0

    monkeypatch.setattr(timing, 'elapsed_ms', one_second)
    seen = []
    images = torch.zeros(3, 4, 5, 3)
    seeds = torch.zeros(3, dtype=torch.int32)
    fn = getattr(tpsb if entry == 'bench' else tpf, entry)
    ips = fn(lambda im, s: seen.append(int(s[0])), images, seeds)
    inner = tpsb.INNER if entry == 'bench' else 4
    assert ips == 3 * inner
    assert len(seen) == 5 * inner and len(set(seen)) == len(seen)
