"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped where torch sees no GPU.  On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small and odd (tile edges inside and outside the image); the
main-path shapes are checked by chip_smoke.py.  Tolerances as in
test_torch_fused_noise.py: sap + median and the packed NMS words are
exact; gaussian + blur may move a u8 by one where logf/cosf round their
last ulp differently, on at most 1e-3 of the pixels.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from tpudenoise_torch.eval.harness import set_matmul_precision
    set_matmul_precision()
    return torch.device('cuda')


SHAPES = [(3, 24, 40), (2, 37, 29), (1, 17, 300)]


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
@pytest.mark.parametrize('double', [True, False])
def test_fused_kernels_match_plain(dev, shape, dtype, double):
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(sum(shape))
    im = torch.from_numpy(rng.randint(0, 256, shape + (3,))).to(dtype)
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape[0])
                             .astype(np.int32))
    sig = torch.from_numpy(np.sqrt(np.asarray([0.1, 1.0, 1.5], np.float32))
                           [np.arange(shape[0]) % 3])
    want = fk.fused_sap_median_batched(im, seeds, 0.4, double)
    got = fk.fused_sap_median_batched(im.to(dev), seeds.to(dev), 0.4, double)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)
    for sigmas in (None, sig):
        want = fk.fused_gaussian_blur(im, seeds, 0.1, double, sigmas=sigmas)
        got = fk.fused_gaussian_blur(
            im.to(dev), seeds.to(dev), 0.1, double,
            sigmas=None if sigmas is None else sigmas.to(dev)).cpu()
        diff = (got.float() - want.float()).abs()
        assert diff.max() <= 1
        assert (diff.amax(-1) > 0).float().mean() <= 1e-3


@pytest.mark.parametrize('n', [512, 1024, 6144])
def test_suppression_masks_match_plain(dev, n):
    from tpudenoise_torch.ops import nms
    rng = np.random.RandomState(n)
    xy = rng.uniform(0, 400, (2, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 120, (2, n, 2))], -1)
    boxes[:, 1::7] = boxes[:, ::7][:, :boxes[:, 1::7].shape[1]]   # dups
    boxes = torch.from_numpy(boxes.astype(np.float32))
    want = nms.build_suppression_masks(boxes, 0.7)
    got = nms.build_suppression_masks_cuda(boxes.to(dev), 0.7).cpu()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


ALL_KINDS = [(0, 0.0), (1, 0.1), (2, 0.0), (3, 0.4), (4, 0.5), (5, 7.0),
             (6, 0.6), (7, 0.09), (8, 100.0), (9, 0.1), (10, 0.2),
             (11, 0.0), (12, 0.0), (7, 0.9), (8, -1.0), (5, 10.0)]
# bound for the kinds that go through logf/expf/cosf: the kernel and
# torch's CUDA ops both call libdevice's, so they should agree exactly;
# the stated bound is a mod-256 distance <= 1 on <= 1e-3 of the elements
# (gaussian's [0, 1] floats: <= 1e-6)
TRANSCENDENTAL = {1, 2, 4, 6, 9, 10}


def _mix_batch(dev, h, w, entries, seed):
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.mix_prologue import fixed_prologue
    rng = np.random.RandomState(seed)
    im = torch.from_numpy(rng.randint(0, 256, (len(entries), h, w, 3))
                          .astype(np.uint8))
    keys = prng.split(prng.PRNGKey(seed), len(entries))
    kinds, *args = fixed_prologue(keys, im, entries)
    return im.to(dev), kinds, [a.to(dev) for a in args]


def _check_mix(got, want, entries):
    for i, (kind, _) in enumerate(entries):
        d = (got[i] - want[i]).abs()
        if kind in TRANSCENDENTAL:
            d = torch.minimum(d, 256.0 - d) if kind != 1 else d * 1e6
            assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3, kind
        else:
            assert d.max() == 0, kind


@pytest.mark.parametrize('shape', [(24, 40), (37, 70), (21, 300)])
def test_mix_kernels_match_plain(dev, shape):
    """All 13 kinds (brownian, periodic and quant twice), including H, W
    off the 16x64 / 256 tile grid."""
    from tpudenoise_torch.noise import mix_kernels as mk
    im, kinds, args = _mix_batch(dev, *shape, ALL_KINDS, sum(shape))
    for fn, plain in ((mk.fused_mix_noise, mk.fused_mix_noise_plain),
                      (mk.fused_mix_bilateral, mk.fused_mix_bilateral_plain)):
        got = fn(im, *args, kinds)
        torch.cuda.synchronize()
        _check_mix(got, plain(im, *args, kinds), ALL_KINDS)


def test_brownian_long_rows_bitexact(dev):
    """Rows of 1500 elements (more than one scan thread each) and 45 rows:
    the kernel's log-step scans against the plain version's."""
    from tpudenoise_torch.noise import mix_kernels as mk
    entries = [(7, 0.9), (7, 0.009)]
    im, kinds, args = _mix_batch(dev, 45, 500, entries, 5)
    for fn, plain in ((mk.fused_mix_noise, mk.fused_mix_noise_plain),
                      (mk.fused_mix_bilateral, mk.fused_mix_bilateral_plain)):
        got = fn(im, *args, kinds)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(im, *args, kinds), atol=0,
                                   rtol=0)


@pytest.mark.parametrize('shape', [(3, 24, 40), (2, 37, 300)])
@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
def test_bloom_kernel_matches_plain(dev, shape, dtype):
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.bloom import bloom_batched
    from tpudenoise_torch.noise.generators import (bloom_apply_scan,
                                                   bloom_params)
    b, h, w = shape
    rng = np.random.RandomState(w)
    im = torch.from_numpy(rng.randint(0, 256, shape + (3,))).to(dtype).to(dev)
    params = torch.from_numpy(bloom_params(prng.split(prng.PRNGKey(h), b),
                                           h, w)).to(dev)
    got = bloom_batched(im, params)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bloom_apply_scan(im, params), atol=0,
                               rtol=0)


def test_wrappers_refuse_other_devices(dev):
    from tpudenoise_torch.noise import fused_kernels as fk
    im = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        fk.fused_sap_median_batched(im, torch.zeros(1, dtype=torch.int32))
