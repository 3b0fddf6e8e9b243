"""The port's BGR <-> LAB (ops/color.py) against the JAX package's, both
ways, and the u8 helpers of noise/generators.py.

Tolerance: the LAB values are rounded to u8 after a power (** 2.4 or
** (1/2.4)) and a cube root, whose last ulp differs between XLA's CPU
code and torch's; a value that lands within an ulp of .5 can round the
other way, so |diff| <= 1 on <= 0.1% of the pixels (measured 0.01% for
BGR -> LAB and 0 for LAB -> BGR over 20000 pixels)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import numpy as np
import pytest
import torch

from tpudenoise.noise import generators as G
from tpudenoise.ops import color as jcolor
from tpudenoise_torch.noise import generators as TG
from tpudenoise_torch.ops import color


def _close(got, want):
    diff = np.abs(got - want)
    share = float(np.mean(diff.max(-1) > 0))
    print(f'max |diff| {diff.max()}, changed pixels {share:.2e}')
    assert diff.max() <= 1 and share <= 1e-3


@pytest.mark.parametrize('seed', [0, 1])
def test_bgr_to_lab_matches_jax(seed):
    px = np.random.RandomState(seed).randint(0, 256, (20000, 3)).astype(
        np.float32)
    px[:512] = np.arange(512)[:, None] // 2   # the grey axis and the dark end
    want = np.asarray(jax.jit(jcolor.bgr_u8_to_lab_u8)(px))
    _close(color.bgr_u8_to_lab_u8(torch.from_numpy(px)).numpy(), want)


@pytest.mark.parametrize('seed', [0, 1])
def test_lab_to_bgr_matches_jax(seed):
    lab = np.random.RandomState(seed).randint(0, 256, (20000, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jcolor.lab_u8_to_bgr_u8)(lab))
    _close(color.lab_u8_to_bgr_u8(torch.from_numpy(lab)).numpy(), want)


def test_lab_image_shape_kept():
    img = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (5, 7, 3)).astype(np.float32))
    lab = color.bgr_u8_to_lab_u8(img)
    assert lab.shape == img.shape and lab.dtype == torch.float32
    assert color.lab_u8_to_bgr_u8(lab).shape == img.shape


def test_u8_casts_and_unique_count_match_jax():
    x = np.random.RandomState(2).uniform(-700, 700, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        TG.wrap_cast_u8(torch.from_numpy(x)).numpy(),
        np.asarray(G.wrap_cast_u8(x)))
    np.testing.assert_array_equal(
        TG.saturate_u8(torch.from_numpy(x)).numpy(),
        np.asarray(G.saturate_u8(x)))
    rng = np.random.RandomState(4)
    for hi in (1, 7, 128, 129, 256):
        im = rng.randint(0, hi, (30, 20, 3)).astype(np.float32)
        im[0, 0] = [-0.6, 255.4, 300.0]    # out of range: not counted
        assert int(TG.u8_unique_count(torch.from_numpy(im))) == int(
            G._u8_unique_count(im))
