"""The port's denoise stencils (`denoise/stencils.py`) and the batched
bilateral (`denoise/bilateral.py:bilateral_batched`) against the JAX
package's on the CPU.

On u8-domain images the 3x3 filters' sums are exact in f32, so median3,
gaussian_blur3 and mean3 are bit-exact; the bilateral is bit-exact
against both `stencils.bilateral` and the Pallas `bilateral_pallas` in
interpret mode (the same f32 operations in the same order; its CUDA
kernel is held against the same plain version on the card)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.stencils as js
from tpudenoise.denoise.pallas_bilateral import bilateral_pallas
from tpudenoise_torch.denoise import bilateral as tb
from tpudenoise_torch.denoise import stencils as ts

SHAPES = [(2, 24, 40), (3, 17, 29)]


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    im[0, :, :5] = 0.0          # a flat zero band, as clipped noise makes
    im[-1, 3:6] = 255.0
    return im


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('name', ['median3', 'gaussian_blur3', 'mean3'])
def test_3x3_stencils_bitexact(shape, name):
    im = _images(shape, sum(shape))
    want = np.asarray(jax.vmap(getattr(js, name))(jnp.asarray(im)))
    got = getattr(ts, name)(torch.from_numpy(im)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', SHAPES)
def test_bilateral_bitexact_against_both(shape):
    im = _images(shape, 7)
    got = ts.bilateral(torch.from_numpy(im)).numpy()
    want = np.asarray(jax.vmap(js.bilateral)(jnp.asarray(im)))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(bilateral_pallas(jnp.asarray(im), tile_h=16,
                                         interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_bilateral_wrapper_checks():
    good = torch.zeros((1, 8, 8, 3))
    assert tb.bilateral_batched(good).shape == good.shape
    with pytest.raises(TypeError):
        tb.bilateral_batched(good.to(torch.uint8))
    with pytest.raises(ValueError):
        tb.bilateral_batched(torch.zeros((8, 8, 3)))
