"""The port's curvelet denoiser (`denoise/curvelet.py`, `torch.fft`), the
`curvelet` noise plan and `cli.fdct` against the JAX package on the CPU.

Bounds, each with its reason (measured values in brackets):
* `_wedge_windows`: the same numpy code, bit-equal;
* `quantile_linear`: `jnp.quantile`'s linear interpolation bit for bit,
  above 2^24 elements too (the index rounds in float32 there);
* the frame (H and W >= 32): XLA's and torch's CPU FFTs round apart by
  ~1e-6, which can move a pixel across a u8 rounding boundary or a
  coefficient across the threshold: within 1 level on <= 5e-3 of the
  pixels [<= 3.0e-3 over 8 seeds at 40x56 and 64x96];
* the small-image fallback (< 32 px): a real image's spectrum comes in
  conjugate pairs of equal magnitude, and the median threshold falls
  between the two of a pair, so which of them survives is decided by the
  FFT's last ulp: the kept sets differ only at coefficients within 2e-6
  relative of the threshold, and the pixels by at most 4 levels [at
  16x31 seed 3: 3 levels on 28.8% of the pixels; 0 at 24x40];
* the `curvelet` plan: keyed is the fused mix kernel, then the curvelet
  (the mix kernel's bytes are held by tests/test_torch_mix.py), the
  curvelet within the frame's bound of JAX's on the same noisy batch;
  masked (the mix scan, then the curvelet over the canvas) within the
  frame's bound of the JAX package's `run_masked` [keyed 1.7e-3, masked
  5.5e-4 of the pixels off by 1];
* `cli.fdct` on a `.npy` image within the frame's bound of the JAX tool
  on the same pixels as a PNG [6.0e-4].
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.noise.pallas_bloom as pb
from tpudenoise.denoise import curvelet as jc
from tpudenoise.noise.pipeline import make_pipeline as jax_make_pipeline
from tpudenoise_torch.core import prng
from tpudenoise_torch.denoise import curvelet as tc
from tpudenoise_torch.noise.mix_kernels import fused_mix_noise
from tpudenoise_torch.noise.mix_prologue import mix_prologue, plan_tables
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.noise.spec import parse


@pytest.fixture(scope='module', autouse=True)
def _jax_setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update('jax_threefry_partitionable', True)
    saved = pb.bloom_pallas
    pb.bloom_pallas = functools.partial(saved, interpret=True)
    yield
    pb.bloom_pallas = saved
    jax.config.update('jax_threefry_partitionable', old)


_jax_curvelet = jax.jit(jax.vmap(jc.curvelet_denoise_u8))


def _frame_close(want: np.ndarray, got: np.ndarray):
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(want.astype(np.float64) - got)
    print(f'max |diff| {d.max()}, changed {np.mean(d > 0):.2e}')
    assert d.max() <= 1 and np.mean(d > 0) <= 5e-3


@pytest.mark.parametrize('shape', [(64, 96), (37, 53), (20, 24)])
def test_wedge_windows_bit_equal(shape):
    np.testing.assert_array_equal(tc._wedge_windows(*shape, 4, 16),
                                  jc._wedge_windows(*shape, 4, 16))


def test_quantile_linear_matches_jnp():
    rng = np.random.RandomState(0)
    x = rng.rand(3, 1001).astype(np.float32)
    x[0, :600] = x[0, 7]                      # the median repeats
    x[1, 1::2] = x[1, 0:-1:2]                 # pairs of equal values
    for n in (1001, 1000, 2):
        for q in (0.5, 0.25, 0.9):
            want = np.asarray(jnp.quantile(jnp.asarray(x[:, :n]), q,
                                           axis=1))
            got = tc.quantile_linear(torch.from_numpy(x[:, :n]), q).numpy()
            np.testing.assert_array_equal(got, want)
    # above 2^24 the float32 index q * (n - 1) rounds (n - 1 to even):
    # on distinct sorted values (XLA's CPU sort takes half the time on
    # sorted input) the order statistic at the rounded index, where the
    # exact index would interpolate
    n = 2**24 + 2
    big = (np.arange(n, dtype=np.float64) / n).astype(np.float32)[None]
    got = tc.quantile_linear(torch.from_numpy(big), 0.5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnp.quantile(jnp.asarray(big[0]), 0.5))[None])
    assert got[0] == big[0, n // 2 - 1] != big[0, n // 2]


@pytest.mark.parametrize('shape', [(64, 96), (40, 56)])
def test_curvelet_matches_jax(shape):
    imgs = np.random.RandomState(sum(shape)).randint(
        0, 256, (2, *shape, 3)).astype(np.float32)
    want = np.asarray(_jax_curvelet(jnp.asarray(imgs)))
    got = tc.curvelet_denoise_batched(torch.from_numpy(imgs)).numpy()
    _frame_close(want, got)
    _frame_close(want[1], tc.curvelet_denoise_u8(
        torch.from_numpy(imgs[1])).numpy())


@pytest.mark.parametrize('shape,seed', [((24, 40), 0), ((16, 31), 3)])
def test_curvelet_fallback_matches_jax(shape, seed):
    img = np.random.RandomState(seed).randint(0, 256, (*shape, 3)).astype(
        np.float32)
    x = img * np.float32(1.0 / 255.0)
    mag_j = np.abs(np.asarray(jax.jit(lambda a: jnp.fft.fft2(
        a, axes=(0, 1)))(jnp.asarray(x))))
    th_j = np.asarray(jnp.quantile(jnp.asarray(mag_j.reshape(-1, 3)), 0.5,
                                   axis=0))
    mag_t = torch.fft.fft2(torch.from_numpy(x).permute(2, 0, 1)).abs()
    th_t = tc.quantile_linear(mag_t.reshape(3, -1), 0.5).numpy()
    kept_t = mag_t.permute(1, 2, 0).numpy() >= th_t
    differ = (mag_j >= th_j) != kept_t
    assert np.all(np.abs(mag_j - th_j)[differ] <= 2e-6 * th_j.max())
    want = np.asarray(jc.curvelet_denoise_u8(jnp.asarray(img)))
    got = tc.curvelet_denoise_u8(torch.from_numpy(img)).numpy()
    d = np.abs(want - got)
    print(f'{shape}: {differ.sum()} coefficients kept apart, max |diff| '
          f'{d.max()}, changed {np.mean(d > 0):.3f}')
    assert d.max() <= 4


def _canvas_inputs(seed):
    rng = np.random.RandomState(seed)
    hw = np.array([[40, 56], [33, 50], [36, 41]], np.int32)
    imgs = np.zeros((3, 40, 56, 3), np.float32)
    for i, (h, w) in enumerate(hw):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        imgs[i] = np.pad(im, ((0, 40 - h), (0, 56 - w), (0, 0)),
                         mode='edge')
    return imgs, hw, prng.fold_in(prng.PRNGKey(seed), np.arange(3))


def test_curvelet_plan_keyed():
    """The fused mix kernel's noise (its plain version here), then the
    curvelet over the batch; the curvelet of that same noisy batch within
    the frame's bound of JAX's."""
    imgs, _, keys = _canvas_inputs(5)
    fn = make_pipeline('curvelet')
    assert fn.backend == 'cuda:fused_mix'
    got = fn.keyed(keys, torch.from_numpy(imgs)).numpy()
    plan = parse('curvelet')
    kinds, eb, el = plan_tables(plan.specs)
    ks = prng.split(keys, 1)[:, 0]
    x = torch.from_numpy(imgs.astype(np.uint8))
    noisy = fused_mix_noise(x, *mix_prologue(ks, x, kinds, eb, el), kinds)
    np.testing.assert_array_equal(
        got, tc.curvelet_denoise_batched(noisy).numpy())
    _frame_close(np.asarray(_jax_curvelet(jnp.asarray(
        noisy.to(torch.float32).numpy()))), got)


def test_curvelet_plan_masked_matches_jax():
    """The bucketed form: the mix scan with hw, then the curvelet over the
    whole canvas (the reference's post-pass takes no hw)."""
    imgs, hw, keys = _canvas_inputs(6)
    want = np.asarray(jax_make_pipeline('curvelet', use_pallas=True).masked(
        jnp.asarray(keys), jnp.asarray(imgs), jnp.asarray(hw)))
    got = make_pipeline('curvelet').masked(keys, torch.from_numpy(imgs),
                                           hw).numpy()
    _frame_close(want, got)


def test_fdct_cli_on_npy(tmp_path, capsys):
    cv2 = pytest.importorskip('cv2')
    from tpudenoise.cli import fdct as jfdct
    from tpudenoise_torch.cli import fdct
    im = np.random.RandomState(2).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    np.save(tmp_path / 'im.npy', im)
    cv2.imwrite(str(tmp_path / 'im.png'), im)
    out = str(tmp_path / 'out.npy')
    got = fdct.main(['sap_var0.4', str(tmp_path / 'im.npy'), '--out', out,
                     '--device', 'cpu'])
    assert osp.exists(out) and f'wrote {out}' in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(out), got.astype(np.uint8))
    jfdct.main(['sap_var0.4', str(tmp_path / 'im.png'), '--out',
                str(tmp_path / 'jax.png')])
    _frame_close(cv2.imread(str(tmp_path / 'jax.png')).astype(np.float32),
                 got)
