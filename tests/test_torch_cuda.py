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


GAUSS_EDGE_SHAPES = [(1, 2, 2), (1, 2, 7), (2, 3, 5), (8, 37, 101),
                     (1, 130, 333), (1, 260, 100), (2, 601, 999)]


def _gauss_forms(shape):
    """Kernel 2's inputs by route: (images, var) with u8 and f32 values
    (the integer route, with and without noise) and f32 values that are
    not integers, of both signs from 1e-2 to 1e9, NaN and inf (the float
    route)."""
    rng = np.random.RandomState(sum(shape))
    im = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    frac = im + rng.uniform(-0.5, 0.5, im.shape).astype(np.float32)
    wide = (rng.choice([-1, 1], im.shape)
            * 10.0 ** rng.uniform(-2, 9, im.shape)).astype(np.float32)
    wide.reshape(-1)[rng.randint(0, wide.size, 3)] = [np.nan, np.inf,
                                                      -np.inf]
    u8 = torch.from_numpy(im).to(torch.uint8)
    return {'u8 + noise': (u8, 0.1), 'u8': (u8, 0.0),
            'f32 + noise': (torch.from_numpy(im), 0.1),
            'f32 non-integers + noise': (torch.from_numpy(frac), 0.1),
            'f32 non-integers': (torch.from_numpy(frac), 0.0),
            'f32 wide range': (torch.from_numpy(wide), 0.0)}


@pytest.mark.parametrize('shape', GAUSS_EDGE_SHAPES)
@pytest.mark.parametrize('double', [True, False])
def test_gauss_blur_kernel_edges_match_plain(dev, shape, double):
    """Kernel 2 at H = 2 and W = 2, odd widths (rows not aligned), heights
    off its row segments (260 rows walk in segments of 8, the last one
    partial), B = 1 and 8, both routes, one and two blurs: without noise
    bit for bit (NaN where NaN), with noise within the bound of
    test_fused_kernels_match_plain."""
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(shape[1])
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape[0])
                             .astype(np.int32))
    for form, (im, var) in _gauss_forms(shape).items():
        want = fk.fused_gaussian_blur(im, seeds, var, double)
        got = fk.fused_gaussian_blur(im.to(dev), seeds.to(dev), var,
                                     double).cpu()
        assert got.dtype == im.dtype, form
        if var == 0.0:
            if im.dtype == torch.uint8:
                assert torch.equal(got, want), form
            else:
                _same_bits(got, want)
            continue
        diff = (got.float() - want.float()).abs()
        assert diff.max() <= 1, form
        assert (diff.amax(-1) > 0).float().mean() <= 1e-3, form


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


def _nms_batch(seed, p, n, ties=False):
    """(p, n, 4) boxes taken as score-sorted, with duplicates, and a (p, n)
    validity mask with invalid rows; ties=True clusters the boxes so that
    long suppression chains form."""
    rng = np.random.RandomState(seed)
    span = 60 if ties else 900
    xy = rng.uniform(0, span, (p, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 300, (p, n, 2))], -1)
    boxes[:, 1::9] = boxes[:, ::9][:, :boxes[:, 1::9].shape[1]]   # dups
    if ties:
        boxes = np.round(boxes / 8) * 8
    valid = rng.uniform(size=(p, n)) > 0.15
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(valid))


@pytest.mark.parametrize('p,n,max_out,ties', [(8, 6144, 300, False),
                                              (8, 6144, 6144, False),
                                              (160, 320, 100, True)])
def test_greedy_keep_matches_plain(dev, p, n, max_out, ties):
    """The walk kernel's keep positions bit-exact against its plain
    version (fixpoint sweeps): the RPN's 8 x 6144 with and without the
    early stop, and the postprocess batch with ties."""
    from tpudenoise_torch.ops import nms
    boxes, valid = _nms_batch(n + max_out, p, n, ties)
    words = nms.build_suppression_masks(boxes, 0.7 if n > 320 else 0.3)
    want = nms.greedy_keep_plain(words, valid, max_out)
    got = nms.greedy_keep(words.to(dev), valid.to(dev), max_out)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    torch.testing.assert_close(got.cpu().long(), want, atol=0, rtol=0)


def test_suppression_masks_postprocess_batch(dev):
    """Kernel 3 on the postprocess shape (160 problems of 320 boxes) with
    invalid (zero-padded) rows, word for word."""
    from tpudenoise_torch.ops import nms
    boxes, valid = _nms_batch(5, 160, 320, ties=True)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    boxes[:, 300:] = 0.0
    want = nms.build_suppression_masks(boxes, 0.3)
    got = nms.build_suppression_masks_cuda(boxes.to(dev), 0.3).cpu()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_nms_entries_do_not_synchronize(dev):
    """nms_packed, nms_fixpoint, proposal_layer and postprocess_detections
    on device-resident inputs under sync debug mode 'error' (second calls:
    the first build the kernels); the two NMS entries keep what the same
    calls keep on the CPU."""
    from tpudenoise_torch.eval.harness import postprocess_detections
    from tpudenoise_torch.ops import nms
    from tpudenoise_torch.ops.anchors import anchor_grid
    from tpudenoise_torch.ops.proposal import proposal_layer
    rng = np.random.RandomState(2)
    boxes, valid = _nms_batch(3, 2, 1000)
    scores = torch.from_numpy(np.round(rng.uniform(size=(2, 1000)) * 16)
                              .astype(np.float32) / 16)
    anchors = anchor_grid(19, 32)
    k = anchors.shape[0]
    rpn_s = torch.from_numpy(rng.uniform(size=(2, k)).astype(np.float32))
    rpn_d = torch.from_numpy((rng.randn(2, k, 4) * 0.2).astype(np.float32))
    im_hw = torch.tensor([[300., 500.], [280., 512.]])
    r, c = 300, 5
    rois = torch.from_numpy(np.concatenate([rng.uniform(0, 200, (2, r, 2)),
                                            rng.uniform(220, 400, (2, r, 2))],
                                           -1).astype(np.float32))
    roi_mask = torch.from_numpy(rng.uniform(size=(2, r)) > 0.1)
    cls_prob = torch.softmax(torch.from_numpy(rng.randn(2, r, c).astype(
        np.float32)), -1)
    bbox_pred = torch.from_numpy((rng.randn(2, r, 4 * c) * 0.1).astype(
        np.float32))
    im_info = torch.tensor([[400., 500., 1.0], [400., 512., 1.0]])
    host = dict(boxes=boxes, scores=scores, valid=valid, rpn_s=rpn_s,
                rpn_d=rpn_d, anchors=anchors, im_hw=im_hw, rois=rois,
                roi_mask=roi_mask, cls_prob=cls_prob, bbox_pred=bbox_pred,
                im_info=im_info)
    card = {k: v.to(dev) for k, v in host.items()}
    calls = {
        'nms_packed': lambda t: nms.nms_packed(
            t['boxes'], t['scores'], 0.7, 300, valid=t['valid']),
        'nms_fixpoint': lambda t: nms.nms_fixpoint(
            t['boxes'][:, :300], t['scores'][:, :300], 0.3, 100,
            valid=t['valid'][:, :300]),
        'proposal_layer': lambda t: proposal_layer(
            t['rpn_s'], t['rpn_d'], t['anchors'], t['im_hw'], 0.7, 2000,
            300),
        'postprocess_detections': lambda t: postprocess_detections(
            t['rois'], t['roi_mask'], t['cls_prob'], t['bbox_pred'],
            t['im_info'], c, 0.3, 0.05)}
    for name, call in calls.items():
        first = call(card)                  # builds and warms
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = call(card)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        for g, f in zip(got, first):
            assert torch.equal(g, f), name
        if name.startswith('nms'):
            # the same inputs on the CPU: the same keep set
            for g, w in zip(got, call(host)):
                assert torch.equal(g.cpu(), w), name
        assert got[-1].any(), name


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


@pytest.mark.parametrize('shape', [(24, 40), (37, 70), (21, 300), (75, 290)])
def test_mix_kernels_match_plain(dev, shape):
    """All 13 kinds (brownian, periodic and quant twice), including H, W
    off the mix + bilateral kernel's 32x64 tile grid (75 x 290: three
    tiles down and five across, the last ones partial) and the mix
    kernel's 256."""
    from tpudenoise_torch.noise import mix_kernels as mk
    im, kinds, args = _mix_batch(dev, *shape, ALL_KINDS, sum(shape))
    for fn, plain in ((mk.fused_mix_noise, mk.fused_mix_noise_plain),
                      (mk.fused_mix_bilateral, mk.fused_mix_bilateral_plain)):
        got = fn(im, *args, kinds)
        torch.cuda.synchronize()
        _check_mix(got, plain(im, *args, kinds), ALL_KINDS)


def _sampler_batch(dev, h, w, case):
    """Two poisson images dark in their left half (lam < 10 there: both
    samplers in the warps at the band's edge), two with four distinct
    values (vals 4: every lam below 4), or two gamma images."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.mix_prologue import fixed_prologue
    rng = np.random.RandomState(h + w + len(case))
    im = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    entries = [(2, 0.0)] * 2
    if case == 'poisson dark half':
        im[:, :, :w // 2] //= 32
    elif case == 'poisson vals 4':
        im = rng.choice(np.asarray([0, 90, 170, 255], np.uint8), im.shape)
    else:
        entries = [(9, 0.2), (9, 1.0)]
    im = torch.from_numpy(im)
    kinds, *args = fixed_prologue(prng.split(prng.PRNGKey(h), 2), im,
                                  entries)
    return im.to(dev), kinds, [a.to(dev) for a in args], entries


@pytest.mark.parametrize('shape', [(24, 40), (37, 71), (75, 290)])
@pytest.mark.parametrize('case', ['poisson dark half', 'poisson vals 4',
                                  'gamma'])
def test_mix_samplers_match_plain(dev, shape, case):
    """Kernels 6 and 7 on the samplers' branches (kernel 6 walks poisson
    and gamma elements a round at a time), with H*W a multiple of 4 (whole
    words) and not (37 x 71), within the transcendental kinds' bound."""
    from tpudenoise_torch.noise import mix_kernels as mk
    im, kinds, args, entries = _sampler_batch(dev, *shape, case)
    for fn, plain in ((mk.fused_mix_noise, mk.fused_mix_noise_plain),
                      (mk.fused_mix_bilateral, mk.fused_mix_bilateral_plain)):
        got = fn(im, *args, kinds)
        torch.cuda.synchronize()
        _check_mix(got, plain(im, *args, kinds), entries)


def test_gauss_and_mix_wrappers_do_not_synchronize(dev):
    """Second calls of kernel 2's wrapper (u8 with noise, f32 without) and
    of kernels 6-7's (poisson, gamma and every other kind) under sync debug
    mode 'error' (the first calls build the kernels)."""
    from tpudenoise_torch.noise import fused_kernels as fk
    from tpudenoise_torch.noise import mix_kernels as mk
    rng = np.random.RandomState(8)
    im = torch.from_numpy(rng.randint(0, 256, (2, 37, 71, 3)).astype(
        np.uint8)).to(dev)
    seeds = torch.tensor([5, -7], dtype=torch.int32, device=dev)
    mix, kinds, args = _mix_batch(dev, 24, 40, ALL_KINDS, 3)
    for strict in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error' if strict else 'default')
        try:
            fk.fused_gaussian_blur(im, seeds, 0.1, True)
            fk.fused_gaussian_blur(im.to(torch.float32), seeds, 0.0, False)
            mk.fused_mix_noise(mix, *args, kinds)
            mk.fused_mix_bilateral(mix, *args, kinds)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()


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


def _same_bits(got, want):
    """Equal float32 bits (signed zeros told apart), NaN where NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.where(nan, 0, got.view(torch.int32)),
                       torch.where(nan, 0, want.view(torch.int32)))


def _bloom_case(name, dev):
    """Inputs that take kernel 8's general form in some or all blocks:
    f32 values outside [0, 255], non-integers, NaN, inf and -0.0; params
    with an alpha outside [0, 1] or step 8's alpha not 1; and widths that
    are not a multiple of the 4 pixels a thread takes (u8 and f32)."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.generators import bloom_params
    h, w = (37, 1001) if name.startswith('width') else (40, 300)
    rng = np.random.RandomState(len(name))
    im = rng.randint(0, 256, (3, h, w, 3)).astype(np.float32)
    params = bloom_params(prng.split(prng.PRNGKey(len(name)), 3), 600, 1000)
    params[:, :8, 0] = [[5, 60, 120, 30, 90, 10, 100, 70]] * 3  # on-image
    if name == 'outside [0, 255]':
        im[0] = im[0] * 2.5 - 200.0
    elif name == 'non-integers':
        im[1] += rng.uniform(-0.5, 0.5, im[1].shape).astype(np.float32)
    elif name == 'nan, inf, -0':
        im[0, 3:9, 40:90] = np.nan
        im[1, 10, 7:20] = np.inf
        im[1, 11, 7:20] = -np.inf
        im[2, :, :64] = -0.0
    elif name == 'alpha outside [0, 1]':
        params[0, 3, 6] = 1.5
        params[1, 20, 6] = -0.25
    elif name == 'alpha[8] not 1':
        params[:2, 8, 6] = 0.5
    elif name == 'colour outside [0, 255]':
        params[0, 2, 3] = 300.0
        params[1, 30, 5] = -7.0
    im = torch.from_numpy(im).to(dev)
    if name == 'width u8':
        im = im.to(torch.uint8)
    return im, torch.from_numpy(params).to(dev)


@pytest.mark.parametrize('name', ['outside [0, 255]', 'non-integers',
                                  'nan, inf, -0', 'alpha outside [0, 1]',
                                  'alpha[8] not 1', 'colour outside [0, 255]',
                                  'width u8', 'width f32'])
def test_bloom_kernel_general_form_bitexact(dev, name):
    """Kernel 8 bit for bit against its plain version where blocks leave
    the fast form (or, for the widths, where threads hold fewer than 4
    pixels and rows are not 16-byte aligned)."""
    from tpudenoise_torch.noise.bloom import bloom_batched
    from tpudenoise_torch.noise.generators import bloom_apply_scan
    im, params = _bloom_case(name, dev)
    got = bloom_batched(im, params)
    torch.cuda.synchronize()
    _same_bits(got, bloom_apply_scan(im, params))


@pytest.mark.parametrize('n', [1, 3, 5, 4095, 4097])
def test_threefry_kernel_odd_sizes(dev, n):
    """64 keys (poisson's PTRS draw) at sizes that leave threads part of
    their 8 counters and put most rows off 16-byte alignment: bits and
    uniforms exact, normals within 2 ulp."""
    from tpudenoise_torch.core import prng
    keys = torch.from_numpy(prng.split(prng.PRNGKey(n + 7), 64).astype(
        np.int64)).to(dev)
    for mode in ('bits', 'uniform', 'normal'):
        got = prng.threefry_draw(keys, n, mode, 0.0, 1.0, 1.41421354)
        want = prng.threefry_draw_plain(keys, n, mode, 0.0, 1.0, 1.41421354)
        torch.cuda.synchronize()
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs()
        assert ulp.max() <= (2 if mode == 'normal' else 0), mode


def test_noise_kernel_wrappers_do_not_synchronize(dev):
    """Second calls of the bloom and threefry wrappers under sync debug
    mode 'error' (the first calls build the kernels)."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.bloom import bloom_batched
    im, params = _bloom_case('non-integers', dev)
    keys = torch.from_numpy(prng.split(prng.PRNGKey(3), 64).astype(
        np.int64)).to(dev)
    for strict in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error' if strict else 'default')
        try:
            bloom_batched(im, params)
            bloom_batched(im.to(torch.uint8), params)
            for mode in ('bits', 'uniform', 'normal'):
                prng.threefry_draw(keys, 4097, mode, 0.0, 1.0, 1.41421354)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()


def test_wrappers_refuse_other_devices(dev):
    from tpudenoise_torch.noise import fused_kernels as fk
    im = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        fk.fused_sap_median_batched(im, torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize('shape', [(3, 24, 40), (2, 37, 70), (1, 17, 300)])
def test_bilateral_kernel_matches_plain(dev, shape):
    """Kernel 5 against its plain version, including tiles past the image
    edge (the BORDER_CONSTANT zeros) and zero bands."""
    from tpudenoise_torch.denoise.bilateral import (bilateral_batched,
                                                    bilateral_plain)
    rng = np.random.RandomState(shape[2])
    im = torch.from_numpy(rng.randint(0, 256, shape + (3,)).astype(
        np.float32))
    im[0, :, :5] = 0.0
    got = bilateral_batched(im.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), bilateral_plain(im), atol=0,
                               rtol=0)


def _bilateral_case(name):
    """Inputs for kernel 5's two colour-weight forms: [0, 1] floats (the
    per-tap expf form in every block); u8 values with one region of
    fractional values (both forms in one launch); all-0 and all-255
    quadrants (d = 0 and 765, the table's ends); u8 values at sizes off
    kernel 5's 32x32 tile grid."""
    rng = np.random.RandomState(len(name))
    if name == 'unit floats':
        return rng.uniform(0.0, 1.0, (2, 45, 150, 3)).astype(np.float32)
    if name == 'both forms':
        im = rng.randint(0, 256, (2, 70, 300, 3)).astype(np.float32)
        im[1, 40:, 150:] += 0.5
        return im
    if name == 'extremes':
        im = np.zeros((1, 70, 270, 3), np.float32)
        im[:, :35, 135:] = 255.0
        im[:, 35:, :135] = 255.0
        return im
    return rng.randint(0, 256, (3, 33, 129, 3)).astype(np.float32)


@pytest.mark.parametrize('name', ['unit floats', 'both forms', 'extremes',
                                  'off the tile grid'])
def test_bilateral_kernel_forms_bitexact(dev, name):
    """Kernel 5 bit-exact against its plain version whichever colour-weight
    form its blocks take."""
    from tpudenoise_torch.denoise.bilateral import (bilateral_batched,
                                                    bilateral_plain)
    im = torch.from_numpy(_bilateral_case(name))
    got = bilateral_batched(im.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), bilateral_plain(im), atol=0,
                               rtol=0)


def test_bilateral_wrappers_do_not_synchronize(dev):
    """Second calls of both bilateral wrappers under sync debug mode
    'error': a blocking host-to-device copy or any other synchronisation
    in either wrapper raises.  (The first calls build the cached
    constants and the kernels.)"""
    from tpudenoise_torch.denoise.bilateral import bilateral_batched
    from tpudenoise_torch.noise import mix_kernels as mk
    im = torch.from_numpy(_bilateral_case('both forms')).to(dev)
    raw, kinds, args = _mix_batch(dev, 37, 70, ALL_KINDS, 8)
    for strict in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error' if strict else 'default')
        try:
            bilateral_batched(im)
            mk.fused_mix_bilateral(raw, *args, kinds)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()


@pytest.mark.parametrize('n', [1, 4097, 600 * 1000 * 3])
def test_threefry_kernel_matches_plain(dev, n):
    """Bits and uniforms exact; normals within 2 ulp (the plain version's
    float64 FMA can round twice)."""
    from tpudenoise_torch.core import prng
    keys = torch.from_numpy(prng.split(prng.PRNGKey(n), 3).astype(np.int64))
    for mode, lo, span, scale in (('bits', 0.0, 1.0, 1.0),
                                  ('uniform', 0.0, 1.0, 1.0),
                                  ('uniform', 1.17549435e-38, 1.0, 1.0),
                                  ('normal', 0.0, 1.0, 1.41421354)):
        got = prng.threefry_draw(keys.to(dev), n, mode, lo, span, scale)
        want = prng.threefry_draw_plain(keys.to(dev), n, mode, lo, span,
                                        scale)
        torch.cuda.synchronize()
        if mode != 'normal':
            torch.testing.assert_close(got, want, atol=0, rtol=0)
        else:
            ulp = (got.view(torch.int32).long()
                   - want.view(torch.int32).long()).abs()
            assert ulp.max() <= 2
        if mode == 'bits':
            np.testing.assert_array_equal(
                got.cpu().numpy().view(np.uint32),
                prng.random_bits(keys.numpy().astype(np.uint32), (n,)))


def test_sap_median_per_image_kernel_matches_plain(dev):
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(4)
    im = torch.from_numpy(rng.randint(0, 256, (3, 37, 29, 3)).astype(
        np.float32))
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, 3).astype(
        np.int32))
    got = fk.fused_sap_median(im.to(dev), seeds.to(dev), 0.4, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), fk.fused_sap_median_plain(
        im, seeds, 0.4, True), atol=0, rtol=0)


# kernel 1's walk at its edges: h = 1, 2, 3, 9; last segments of one row
# short of a whole one (17: 9 + 8) and of one row (57, 161: segments of 8
# on the float route; 65: 11 rows, last 10, on the packed route), on a
# 132-SM card; w = 1, 2; w3 = 759, just over one strip of 756 lanes;
# B = 1 and 9
SAP_EDGE_SHAPES = [(1, 1, 1), (9, 1, 7), (1, 2, 2), (2, 3, 1), (9, 9, 2),
                   (1, 17, 40), (9, 65, 40), (1, 57, 253), (1, 161, 253),
                   (2, 600, 253)]


def _sap_forms(shape):
    """Kernel 1's inputs by route: u8 (the packed route), and f32 integers,
    non-integers and values of both signs from 1e-2 to 1e9 (the float
    route)."""
    rng = np.random.RandomState(sum(shape))
    im = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    frac = im + rng.uniform(-0.5, 0.5, im.shape).astype(np.float32)
    wide = (rng.choice([-1, 1], im.shape)
            * 10.0 ** rng.uniform(-2, 9, im.shape)).astype(np.float32)
    return {'u8': torch.from_numpy(im).to(torch.uint8),
            'f32 integers': torch.from_numpy(im),
            'f32 non-integers': torch.from_numpy(frac),
            'f32 wide range': torch.from_numpy(wide)}


@pytest.mark.parametrize('shape', SAP_EDGE_SHAPES)
@pytest.mark.parametrize('double', [True, False])
def test_sap_median_kernel_edges_match_plain(dev, shape, double):
    """Kernels 1 and 4 bit for bit against fused_sap_median_plain at the
    walk's edge shapes, one and two medians: the batched entry on every
    form, the per-image entry on the f32 forms, and u8 images through the
    float route (`sap_median_u8_float`, the packed route's yardstick)."""
    from tpudenoise_torch import cuda_build
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(shape[1])
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape[0])
                             .astype(np.int32))
    b, h, w = shape
    for form, im in _sap_forms(shape).items():
        want = fk.fused_sap_median_plain(im, seeds, 0.4, double)
        x, s = im.to(dev), seeds.to(dev)
        got = {'batched': fk.fused_sap_median_batched(x, s, 0.4, double)}
        if im.dtype == torch.float32:
            got['per image'] = fk.fused_sap_median(x, s, 0.4, double)
        else:
            got['float route'] = torch.empty_like(x)
            cuda_build.launch('fused_noise', 'sap_median_u8_float', x,
                              got['float route'], s, b, h, 3 * w,
                              fk._sap_threshold_i32(0.4), int(double))
        for entry, out in got.items():
            assert out.dtype == im.dtype, (form, entry)
            if im.dtype == torch.uint8:
                assert torch.equal(out.cpu(), want), (form, entry)
            else:
                _same_bits(out.cpu(), want)


@pytest.mark.parametrize('noise', ['speckle_bilateral_var1.0', 'poisson',
                                   'gamma_var0.1', 'quant_var10',
                                   'uniform_mean_var0.6', 'brownian_var0.9'])
def test_generic_route_card_matches_cpu(dev, noise):
    """The route on the card against itself on the CPU: the draws are
    bit-equal (normals within 2 ulp); torch's CUDA and CPU log/exp/sin
    may differ in a last ulp, so a mod-256 distance <= 1 on <= 1e-3 of
    the elements."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.pipeline import make_pipeline
    raw = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (2, 45, 70, 3)).astype(np.uint8))
    keys = prng.fold_in(prng.PRNGKey(3), np.arange(2))
    fn = make_pipeline(noise)
    got = fn.keyed(keys, raw.to(dev)).cpu()
    want = fn.keyed(keys, raw)
    d = (got - want).abs()
    d = torch.minimum(d, 256.0 - d)
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


@pytest.mark.parametrize('shape,tile_h', [((2, 37, 29), 8), ((1, 17, 300), 16),
                                          ((3, 24, 40), 56)])
@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
def test_sap_stages_kernel_matches_plain(dev, shape, tile_h, dtype):
    """Every stage on an edge-padded raster and on a random raster (pad
    rows and pad lanes included), bit-exact, and the full stage of
    `sap_full_padded` on a random raster; the full stage sliced to (h, w3)
    equals kernel 1 on the same images."""
    from tpudenoise_torch.benchmarks.profile_sap_breakdown import pad_raster
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(sum(shape) + tile_h)
    b, h, w = shape
    im = torch.from_numpy(rng.randint(0, 256, shape + (3,))).to(dtype)
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, b).astype(
        np.int32))
    raster = pad_raster(im, tile_h)
    noise = torch.from_numpy(rng.randint(0, 256, raster.shape)).to(dtype)
    for r in (raster, noise):
        for stage in fk.STAGES:
            got = fk.sap_stages(r.to(dev), seeds.to(dev), h, 3 * w, stage)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(got.cpu(), fk.sap_stages_plain(
                r, seeds, h, 3 * w, stage), atol=0, rtol=0)
    full = fk.sap_stages(raster.to(dev), seeds.to(dev), h, 3 * w, 'full')
    kernel1 = fk.fused_sap_median_batched(im.to(dev), seeds.to(dev), 0.4,
                                          True)
    assert torch.equal(full[:, :h, :3 * w].reshape(b, h, w, 3), kernel1)
    noise = noise.to(torch.float32)
    got = fk.sap_full_padded(noise.to(dev), seeds.to(dev), h, 3 * w, 0.7)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), fk.sap_stages_plain(
        noise, seeds, h, 3 * w, 'full', 0.7), atol=0, rtol=0)


@pytest.mark.parametrize('form', ['non-integers', 'negatives and -0.0',
                                  'integers with a few non-integer rows',
                                  'wide range'])
def test_sap_stages_f32_routes_match_plain(dev, form):
    """f32 rasters that are not all integers in [0, 255]: blocks leave the
    packed route at their first step or in mid-walk and take the float
    walk; the output equals the plain version, and its bits are those of
    the float walk alone (`sap_stages_f32_float`, no wrapper calls it)."""
    from tpudenoise_torch.benchmarks.profile_noise_kernels import (
        stages_f32_float)
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(len(form))
    b, h, w3, hp, w3p = 2, 61, 903, 64, 1024
    raster = rng.randint(0, 256, (b, hp + 8, w3p)).astype(np.float32)
    if form == 'non-integers':
        raster += rng.uniform(-0.5, 0.5, raster.shape).astype(np.float32)
    elif form == 'negatives and -0.0':
        raster -= 128
        raster[rng.rand(*raster.shape) < 0.1] = -0.0
    elif form == 'integers with a few non-integer rows':
        raster[:, rng.randint(20, hp + 8, 3), ::29] += 0.5
    else:
        raster = (rng.choice([-1, 1], raster.shape)
                  * 10.0 ** rng.uniform(-2, 9, raster.shape)).astype(
                      np.float32)
    raster = torch.from_numpy(raster)
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, b).astype(
        np.int32))
    for stage in fk.STAGES:
        got = fk.sap_stages(raster.to(dev), seeds.to(dev), h, w3, stage)
        alone = stages_f32_float(raster.to(dev), seeds.to(dev), h, w3,
                                 stage)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), fk.sap_stages_plain(
            raster, seeds, h, w3, stage), atol=0, rtol=0)
        assert torch.equal(got.view(torch.int32), alone.view(torch.int32))


@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32])
def test_sap_stages_unaligned_rows_match_plain(dev, dtype):
    """Rows that are not 16-byte aligned take the copy and noise stages'
    scalar form: w3p = 130, and a raster that starts one element into its
    buffer."""
    from tpudenoise_torch.noise import fused_kernels as fk
    rng = np.random.RandomState(5)
    b, h, w3, hp, w3p = 2, 13, 126, 16, 130
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, b).astype(
        np.int32)).to(dev)
    n = b * (hp + 8) * w3p
    buf = torch.from_numpy(rng.randint(0, 256, n + 1)).to(dtype).to(dev)
    for raster in (buf[:n].view(b, hp + 8, w3p),
                   buf[1:].view(b, hp + 8, w3p)):
        for stage in fk.STAGES:
            got = fk.sap_stages(raster, seeds, h, w3, stage)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), fk.sap_stages_plain(
                raster.cpu(), seeds.cpu(), h, w3, stage))


def test_res50_chunk_forward_card_matches_cpu(dev):
    """A seeded f32 res50 forward on the card against the CPU: the convs
    sum in another order and the heads run in bf16 in both (their inputs,
    weights and sums round to 8 bits; the seeded res50's logits reach
    several units), so each logit within 2**-5 of its RoI's largest; the
    same proposals kept, each within 0.1 px (the RPN's deltas, from 16
    strided f32 convs summed in another order, go through exp)."""
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    m = FasterRCNN('res50', num_classes=5, dtype=torch.float32)
    m.cfg.TEST.RPN_PRE_NMS_TOP_N, m.cfg.TEST.RPN_POST_NMS_TOP_N = 256, 16
    params = m.init(torch.Generator().manual_seed(0))
    imgs = torch.from_numpy((np.random.RandomState(1).randn(2, 96, 128, 3)
                             * 50).astype(np.float32))
    info = torch.tensor([[96., 128., 1.], [80., 112., 1.]])
    want = m.forward_test(params, imgs, info)
    m.to(dev)
    got = m.forward_test({k: v.to(dev) for k, v in params.items()},
                         imgs.to(dev), info.to(dev))
    assert torch.equal(got['roi_mask'].cpu(), want['roi_mask'])
    diff = (got['cls_score'].cpu() - want['cls_score']).abs()
    scale = want['cls_score'].abs().amax(-1, keepdim=True)
    assert (diff <= 2**-5 * scale).all(), (diff / scale).max()
    for g, w in zip(got['rois'].cpu(), want['rois']):
        assert ((g[:, None] - w[None]).abs().amax(-1).amin(0) < 0.1).all()


def test_cli_test_on_the_card(dev, tmp_path):
    """`tpudenoise_torch.cli.test.main` with `--device cuda` on a 2-image
    600x1000 numpy rrData dataset (its `.npy` pixels where `get_imdb`
    looks): a seeded vgg16, sap_median_var0.4, one chunk of 2; kernel 1
    launches once and kernel 3 and the walk twice each (the RPN's NMS and
    the postprocess NMS); 10 finite APs."""
    import copy

    import tpudenoise_torch.core.config as config
    from tpudenoise_torch.cli import test as cli_test
    from tpudenoise_torch.data import synthetic
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.noise import fused_kernels as fk
    from tpudenoise_torch.ops import nms
    root = str(tmp_path)
    cfg = config.default_config()
    cfg.ROOT_DIR = root
    synthetic.write_rrdata(root, 2, (600, 1000), seed=3, pixel_dir=(
        default_pixel_dir('rrData_2021_test', cfg)))
    saved = copy.deepcopy(config.cfg)
    for counter in (fk.launches, nms.launches):
        for k in counter:
            counter[k] = 0
    try:
        aps = cli_test.main(['--net', 'vgg16', '--imdb', 'rrData_2021_test',
                             '--noise', 'sap_median_var0.4', '--eval-batch',
                             '2', '--device', 'cuda', '--set', 'DATA_DIR',
                             root, 'ROOT_DIR', root])
    finally:
        config.cfg.clear()
        config.cfg.update(saved)
    assert len(aps) == 10 and np.isfinite(aps).all(), aps
    assert fk.launches['sap_median'] == 1, dict(fk.launches)
    assert nms.launches['suppression_masks'] == 2, dict(nms.launches)
    assert nms.launches['greedy_keep'] == 2, dict(nms.launches)


def test_target_layers_card_match_cpu(dev):
    """The training target layers on the card (threefry kernel draws, the
    randint bound a device count) equal the CPU's: labels, sampled rois
    and weights bit for bit; the regression targets within 1e-6 (CUDA's
    logf and division may round their last ulp another way)."""
    from tpudenoise_torch.ops.anchors import anchor_grid
    from tpudenoise_torch.train.targets import (anchor_target_layer,
                                                proposal_target_layer)
    rng = np.random.RandomState(0)
    anchors = anchor_grid(12, 16)
    gt = torch.zeros(2, 4, 5)
    gm = torch.zeros(2, 4, dtype=torch.bool)
    for b in range(2):
        for j in range(2 + b):
            x, y = rng.randint(0, 150), rng.randint(0, 100)
            gt[b, j] = torch.tensor([x, y, x + 60, y + 70, 1.0])
            gm[b, j] = True
    hw = torch.tensor([[190., 250.], [170., 230.]])
    keys = np.array([[1, 2], [3, 4]], np.uint32)
    rois = gt[:, [0, 1, 0, 1, 0, 1] * 20, :4] + torch.from_numpy(
        rng.randn(2, 120, 4).astype(np.float32) * 8)
    mask = torch.ones(2, 120, dtype=torch.bool)
    outs = []
    for d in ('cpu', dev):
        a = anchor_target_layer(keys, anchors.to(d), gt.to(d), gm.to(d),
                                hw.to(d), rpn_batch=64)
        p = proposal_target_layer(keys, rois.to(d), mask.to(d), gt.to(d),
                                  gm.to(d), num_classes=2, batch=32)
        outs.append([t.cpu() for t in (*a, *p)])
    names = ('labels', 'bbox_targets', 'in_w', 'out_w', 'rois', 'labels',
             'bbox_targets', 'in_w', 'out_w')
    for name, x, y in zip(names, *outs):
        if name == 'bbox_targets':
            torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize('noise', ['bloom', 'periodic_var100', 'quant_var7',
                                   'speckle_bilateral_var1.0'])
def test_masked_routes_card_match_cpu(dev, noise):
    """The masked generic and bilateral routes on the card equal the CPU's
    (quant: its palette's centres may differ by ulps, so labels on a
    near-tie; held to 1 on 1e-3 of the elements)."""
    from tpudenoise_torch.noise.pipeline import make_pipeline
    rng = np.random.RandomState(1)
    hw = np.array([[31, 47], [40, 50]])
    imgs = torch.from_numpy(rng.randint(0, 256, (2, 40, 56, 3)).astype(
        np.uint8))
    keys = np.array([[5, 6], [7, 8]], np.uint32)
    fn = make_pipeline(noise, mode='TRAIN')
    want = fn.masked(keys, imgs, hw)
    got = fn.masked(keys, imgs.to(dev), hw).cpu()
    d = (got.double() - want.double()).abs()
    if noise == 'quant_var7':
        assert (d > 0).double().mean() <= 1e-3
    else:
        assert d.max() == 0


def test_train_step_card_matches_cpu(dev):
    """One f32 res50 train step (128x192, batch 2) on the card against the
    CPU: each loss term within 1e-3 relative (cuDNN and the CPU sum the
    convolutions in other orders; a proposal near a score tie can swap)."""
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.train.train_step import make_train_step
    cfg = default_config()
    model = FasterRCNN('res50', num_classes=2, cfg=cfg,
                       anchor_scales=(2, 4, 8), dtype=torch.float32)
    init, step = make_train_step(model, cfg)
    state = init(torch.Generator().manual_seed(0), (128, 192))
    rng = np.random.RandomState(2)
    batch = {'image': torch.from_numpy((rng.rand(2, 128, 192, 3) * 2 - 1)
                                       .astype(np.float32)),
             'im_info': torch.tensor([[128., 192., 1.], [110., 170., 1.]]),
             'gt_boxes': torch.tensor([[[20., 30., 90., 100., 1.]],
                                       [[10., 10., 70., 90., 1.]]]),
             'gt_mask': torch.ones(2, 1, dtype=torch.bool)}
    key = np.array([0, 9], np.uint32)
    _, want = step(state, key, batch)
    on = {k: v.to(dev) for k, v in batch.items()}
    new, got = step(state._replace(
        params={k: v.to(dev) for k, v in state.params.items()},
        momentum={k: v.to(dev) for k, v in state.momentum.items()}), key, on)
    for k in want:
        w, g = want[k].item(), got[k].item()
        assert abs(g - w) <= 1e-3 * abs(w) + 1e-6, (k, g, w)
    assert new.step == 1


@pytest.mark.parametrize('noise', ['noise_mix_var_all',
                                   'noise_mix_var_all_bilateral',
                                   'noise_mix_var_low'])
def test_masked_mix_scan_card_matches_cpu(dev, noise):
    """The mix routes' masked form (the mix scan: threefry, bloom and
    quant per drawn image, then the post-pass: the bilateral kernel) on
    the card against the CPU: the kinds through log/exp/cos and quant's
    near ties within 1 on 1e-3 of the elements (a mod-256 distance)."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.pipeline import make_pipeline
    rng = np.random.RandomState(2)
    hw = np.array([[31, 47], [40, 50], [25, 56], [40, 56], [33, 40],
                   [20, 30]])
    imgs = torch.from_numpy(rng.randint(0, 256, (6, 40, 56, 3)).astype(
        np.uint8))
    keys = prng.fold_in(prng.PRNGKey(3), np.arange(6))
    fn = make_pipeline(noise)
    want = fn.masked(keys, imgs, hw)
    got = fn.masked(keys, imgs.to(dev), hw).cpu()
    d = (got.double() - want.double()).abs()
    d = torch.minimum(d, 256.0 - d)
    assert d.max() <= 1 and (d > 1e-6).double().mean() <= 1e-3


def test_pyramid_postprocess_card_matches_cpu(dev):
    """postprocess_detections_pyramid on the card (kernel 3 and the walk
    over B x (C-1) problems of S * R boxes, COCO's 81 classes) against
    the CPU's dense route: the same masks, boxes within 1e-4."""
    from tpudenoise_torch.eval.harness import postprocess_detections_pyramid
    rng = np.random.RandomState(5)
    b, s, r, c = 2, 2, 40, 81
    x1, y1 = rng.rand(b, s, r) * 50, rng.rand(b, s, r) * 40
    rois = np.stack([x1, y1, x1 + 10 + rng.rand(b, s, r) * 30,
                     y1 + 10 + rng.rand(b, s, r) * 30], -1)
    probs = rng.dirichlet(np.ones(c), size=(b, s, r))
    preds = rng.randn(b, s, r, 4 * c) * 0.1
    mask = rng.rand(b, s, r) > 0.2
    infos = np.tile(np.float32([[[90, 120, 1.5], [60, 80, 1.0]]]),
                    (b, 1, 1))
    args = [torch.from_numpy(np.asarray(a, dtype)) for a, dtype in
            ((rois, np.float32), (mask, bool), (probs, np.float32),
             (preds, np.float32), (infos, np.float32))]
    want = postprocess_detections_pyramid(*args, c, 0.3, 0.001, 100)
    got = postprocess_detections_pyramid(*(a.to(dev) for a in args), c,
                                         0.3, 0.001, 100)
    torch.testing.assert_close(got[2].cpu(), want[2], atol=0, rtol=0)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4, rtol=0)


def test_shape_diverse_test_net_card_matches_cpu(dev, tmp_path):
    """test_net_batched and test_net over a numpy-written VOC set of two
    shapes (two noise buckets) with a two-scale pyramid and the mix
    scan, card against CPU: >= 95% of the CPU's detections with a card
    twin within 0.5."""
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.data import synthetic
    from tpudenoise_torch.data.cache_pixels import default_pixel_dir
    from tpudenoise_torch.data.factory import get_imdb
    from tpudenoise_torch.eval import harness
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    import os.path as osp
    import pickle
    root = str(tmp_path)
    cfg = default_config()
    cfg.DATA_DIR = cfg.ROOT_DIR = root
    cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (128, 160), 200
    cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 256, 64
    synthetic.write_voc(root, [(160, 200), (200, 160), (150, 200)],
                        pixel_dir=default_pixel_dir('voc_2007_test', cfg))
    m = FasterRCNN('vgg16', num_classes=21, cfg=cfg, dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    dets = {}
    for d in ('cpu', dev):
        m.to(d)
        p = {k: v.to(d) for k, v in params.items()}
        for loop, kw in (('test_net', {}), ('test_net_batched',
                                            {'eval_batch': 2})):
            imdb = get_imdb('voc_2007_test', cfg)
            imdb.competition_mode(True)
            name = f'{loop}_{torch.device(d).type}'
            getattr(harness, loop)(m, p, imdb, name, 'noise_mix_var_all',
                                   config=cfg, **kw)
            with open(osp.join(root, 'output', cfg.EXP_DIR, imdb.name, name,
                               'detections.pkl'), 'rb') as f:
                dets[loop, torch.device(d).type] = pickle.load(f)
    for loop in ('test_net', 'test_net_batched'):
        matched = total = 0
        for a, g in zip(dets[loop, 'cpu'][1:], dets[loop, 'cuda'][1:]):
            for x, y in zip(a, g):
                x, y = np.asarray(x).reshape(-1, 5), np.asarray(y)
                assert abs(len(x) - len(y)) <= 1
                for row in x:
                    total += 1
                    matched += bool(len(y) and np.abs(
                        y.reshape(-1, 5) - row).max(1).min() < 0.5)
        assert total > 0 and matched / total >= 0.95, (loop, matched, total)


@pytest.mark.parametrize('n', [1, 5, 4097, 600 * 1000 * 3])
def test_hash_kernel_matches_plain(dev, n):
    """The hash-stream kernel against its plain version on the card: words
    and uniforms bit-exact, Box-Muller normals within 2 ulp (the threefry
    normals' bound); the words equal the CPU's too.  Seed words with the
    top bit set and odd sizes (scalar stores at a row's end)."""
    from tpudenoise_torch.core import prng
    seeds = torch.tensor([[0, 7], [0xFFFFFFFF, 0x80000001],
                          [12345, 0xDEADBEEF]], dtype=torch.int64)
    for salt in (1, 16, 43, 72):
        for mode in ('bits', 'u01', 'normal'):
            got = prng.hash_draw(seeds.to(dev), n, salt, mode)
            want = prng.hash_draw_plain(seeds.to(dev), n, salt, mode)
            torch.cuda.synchronize()
            if mode == 'normal':
                ulp = (got.view(torch.int32).long()
                       - want.view(torch.int32).long()).abs()
                assert ulp.max() <= 2, (salt, ulp.max())
            else:
                torch.testing.assert_close(got, want, atol=0, rtol=0)
        if n <= 4097:
            assert torch.equal(prng.hash_draw(seeds.to(dev), n, salt,
                                              'bits').cpu(),
                               prng.hash_draw_plain(seeds, n, salt, 'bits'))


@pytest.mark.parametrize('noise', ['poisson', 'gamma_var0.3',
                                   'brownian_var0.09',
                                   'speckle_bilateral_var1.0'])
def test_fast_rng_routes_card_match_cpu(dev, noise):
    """The `--fast-rng` routes on the card against the CPU, keyed and
    masked: the hash draws are bit-equal (normals within 2 ulp); torch's
    CUDA and CPU log/exp/cos may differ in a last ulp, so a mod-256
    distance <= 1 on <= 1e-3 of the elements."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.pipeline import make_pipeline
    raw = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (2, 45, 70, 3)).astype(np.uint8))
    keys = prng.fold_in(prng.PRNGKey(3), np.arange(2))
    hw = np.array([[45, 70], [40, 61]])
    fn = make_pipeline(noise, fast_rng=True)
    for got, want in ((fn.keyed(keys, raw.to(dev)).cpu(), fn.keyed(keys, raw)),
                      (fn.masked(keys, raw.to(dev), hw).cpu(),
                       fn.masked(keys, raw, hw))):
        d = (got - want).abs()
        d = torch.minimum(d, 256.0 - d)
        assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


def test_curvelet_card_matches_cpu(dev):
    """The curvelet (cuFFT and the bitwise select on the card) against
    the CPU on two 160x200 images and in the small-image fallback: cuFFT
    and the CPU's FFT round apart, so as tests/test_torch_curvelet.py
    holds it against JAX: within 1 level on <= 5e-3 of the pixels (the
    fallback: within 4 levels, a conjugate pair at the threshold)."""
    from tpudenoise_torch.denoise.curvelet import curvelet_denoise_batched
    rng = np.random.RandomState(4)
    for shape, bound, share in (((2, 160, 200, 3), 1, 5e-3),
                                ((2, 24, 31, 3), 4, 1.0)):
        imgs = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
        want = curvelet_denoise_batched(imgs)
        got = curvelet_denoise_batched(imgs.to(dev)).cpu()
        d = (got - want).abs()
        assert d.max() <= bound and (d > 0).float().mean() <= share


def test_mobile_forward_card_matches_cpu(dev):
    """A seeded f32 mobile (full width, BN statistics randomized: the
    seeded BN is the identity) on the card against the CPU, with
    test_res50_chunk_forward_card_matches_cpu's bounds: each logit within
    2**-5 of its RoI's largest (the heads run in bf16), the same
    proposals kept, each within 0.1 px."""
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    m = FasterRCNN('mobile', num_classes=5, dtype=torch.float32)
    m.cfg.TEST.RPN_PRE_NMS_TOP_N, m.cfg.TEST.RPN_POST_NMS_TOP_N = 256, 16
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    for name, p in params.items():
        if name.rsplit('.', 1)[-1] in ('gamma', 'var'):
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
        elif name.rsplit('.', 1)[-1] in ('beta', 'mean'):
            p.copy_(torch.from_numpy(rng.randn(*p.shape) * 0.1))
    imgs = torch.from_numpy((np.random.RandomState(1).randn(2, 96, 128, 3)
                             * 50).astype(np.float32))
    info = torch.tensor([[96., 128., 1.], [80., 112., 1.]])
    want = m.forward_test(params, imgs, info)
    m.to(dev)
    got = m.forward_test({k: v.to(dev) for k, v in params.items()},
                         imgs.to(dev), info.to(dev))
    assert torch.equal(got['roi_mask'].cpu(), want['roi_mask'])
    diff = (got['cls_score'].cpu() - want['cls_score']).abs()
    scale = want['cls_score'].abs().amax(-1, keepdim=True)
    assert (diff <= 2**-5 * scale).all(), (diff / scale).max()
    for g, w in zip(got['rois'].cpu(), want['rois']):
        assert ((g[:, None] - w[None]).abs().amax(-1).amin(0) < 0.1).all()


AUG_NAMES = ['random_brightness', 'add_shadow', 'add_snow', 'add_rain',
             'add_fog', 'add_gravel', 'add_sun_flare', 'add_speed',
             'add_autumn', 'random_flip', 'add_manhole']


@pytest.mark.parametrize('name', AUG_NAMES)
def test_automold_card_matches_cpu(dev, name):
    """augment_random with one name forced, on two 120x160 images and one
    75x99, card against CPU, tests/test_torch_automold.py's bounds: at
    most 1e-3 of the values more than one level off, 1e-2 off at all;
    add_sun_flare launches kernel 8 once an image, bit-equal."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise import automold
    from tpudenoise_torch.noise import bloom
    assert automold.AUG_TYPES == AUG_NAMES
    rng = np.random.RandomState(7)
    imgs = [rng.randint(0, 256, s).astype(np.float32)
            for s in ((120, 160, 3), (120, 160, 3), (75, 99, 3))]
    before = bloom.launches['bloom']
    for i, im in enumerate(imgs):
        key = prng.fold_in(prng.PRNGKey(9), i)
        want = automold.augment_random(key, torch.from_numpy(im), [name])
        got = automold.augment_random(key, torch.from_numpy(im).to(dev),
                                      [name]).cpu()
        d = (got - want).abs()
        assert (d > 1).float().mean() <= 1e-3 and \
            (d > 0).float().mean() <= 1e-2, d.max()
        if name == 'add_sun_flare':
            assert torch.equal(got, want)
    assert bloom.launches['bloom'] - before == (
        len(imgs) if name == 'add_sun_flare' else 0)
