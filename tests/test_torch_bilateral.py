"""The bilateral's plain version (`denoise/bilateral.py:bilateral_plain`)
on non-integral inputs, and the wrappers' cached launch constants.

The CUDA kernels choose, per block, between a table of the colour weights
of integral d (u8 windows) and one exp per tap (any other window); the
second form must give the plain version's bits on inputs such as the [0, 1]
floats that the gaussian kind feeds a bilateral, so the plain version is
held here, bit for bit, against the JAX package's bilateral
(`stencils.bilateral` under jit) and the Pallas `bilateral_pallas` (in
interpret mode) on such inputs; u8 inputs are held in
test_torch_stencils.py.  The kernels themselves are held against the
plain version on the card (test_torch_cuda.py)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudenoise.denoise.stencils as js
from tpudenoise.denoise.pallas_bilateral import bilateral_pallas
from tpudenoise_torch.denoise import bilateral as tb
from tpudenoise_torch.noise import mix_kernels as mk

SHAPES = [(2, 24, 40), (3, 17, 29)]


def _non_integral(shape, domain):
    rng = np.random.RandomState(sum(shape))
    hi = 1.0 if domain == 'unit' else 255.0
    im = rng.uniform(0.0, hi, shape + (3,)).astype(np.float32)
    im[0, :, :5] = 0.0          # a flat zero band, as clipped noise makes
    return im


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('domain', ['unit', 'u8 range'])
def test_bilateral_plain_bitexact_on_non_integral(shape, domain):
    """[0, 1] floats (the gaussian kind's output) and fractional values in
    [0, 255]: the per-tap exp form of every block."""
    im = _non_integral(shape, domain)
    got = tb.bilateral_plain(torch.from_numpy(im)).numpy()
    want = np.asarray(jax.jit(jax.vmap(js.bilateral))(jnp.asarray(im)))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(bilateral_pallas(jnp.asarray(im), tile_h=16,
                                         interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        tb.bilateral_batched(torch.from_numpy(im)).numpy(), got)


def test_spatial_weights_built_once():
    """One host tensor per sigma_space, the weights of `taps` in order."""
    sw = tb.spatial_weights()
    assert tb.spatial_weights(100.0) is sw
    assert sw.device.type == 'cpu' and sw.dtype == torch.float32
    assert sw.tolist() == [t[2] for t in tb.taps()]
    assert len(sw) == 49 and sw[24] == 1.0          # the centre tap
    other = tb.spatial_weights(50.0)
    assert other is not sw and other.tolist() == [t[2]
                                                  for t in tb.taps(50.0)]


def test_kind_table_built_once_per_device():
    kinds = (0, 5, 7)
    cpu = torch.device('cpu')
    table = mk.kind_table(kinds, cpu)
    assert mk.kind_table(kinds, cpu) is table
    assert table.dtype == torch.int32 and table.tolist() == list(kinds)
    assert mk.kind_table((0, 5), cpu) is not table
