"""The port's NMS against the JAX package: packed suppression words word
for word (integer output, so exact), keep sets equal to the JAX package's
py_cpu_nms oracle, and proposal_layer equal to JAX's on identical inputs, tied
scores included (keep indices exact, rois to 1e-4 px)."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise_torch.ops import nms as tnms

# the module, not the `nms` function that tpudenoise.ops re-exports
jnms = importlib.import_module('tpudenoise.ops.nms')


def near_threshold_pairs(rng, k: int, t: float = 0.7):
    """k box pairs (A, A shifted right by dx) whose f32 IoU, evaluated in
    the reference's operation order, lies at or one ulp beside f32(t):
    dx is nudged by f32 ulps onto the boundary, then a third of the pairs
    step one ulp left and a third one ulp right.  Returns two (k, 4)
    arrays."""
    f, t32 = np.float32, np.float32(t)
    x, y = rng.uniform(0, 300, (2, k)).astype(f)
    w, h = rng.uniform(20, 200, (2, k)).astype(f)
    a = np.stack([x, y, x + w, y + h], 1)

    def shifted(dx):
        return np.stack([x + dx, y, x + dx + w, y + h], 1)

    def iou(b):
        ba = (a[:, 2] - a[:, 0] + f(1)) * (a[:, 3] - a[:, 1] + f(1))
        area = (b[:, 2] - b[:, 0] + f(1)) * (b[:, 3] - b[:, 1] + f(1))
        iw = np.maximum(f(0), np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]) + f(1))
        ih = np.maximum(f(0), np.minimum(a[:, 3], b[:, 3])
                        - np.maximum(a[:, 1], b[:, 1]) + f(1))
        inter = iw * ih
        return inter / ((ba + area) - inter)

    dx = ((w + 1) * f((1 - t) / (1 + t))).astype(f)
    for _ in range(64):
        v = iou(shifted(dx))
        dx = np.where(v == t32, dx, np.nextafter(
            dx, np.where(v > t32, f(np.inf), f(-np.inf)))).astype(f)
    step = rng.randint(-1, 2, k)
    dx = np.where(step == 0, dx, np.nextafter(
        dx, np.where(step > 0, f(np.inf), f(-np.inf)))).astype(f)
    return a, shifted(dx)


def make_boxes(rng, n, with_ties=True):
    """Random (x1, y1, x2, y2) boxes with exact duplicates, pairs whose
    IoU is exactly 0.7 (a 10x10 box and its 10x7 top part: 70/100), and
    pairs within an f32 ulp of IoU 0.7, where any change to the order of
    the IoU arithmetic flips some suppression bits."""
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(4, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if with_ties:
        dup = rng.choice(n, n // 8, replace=False)
        boxes[dup[1:]] = boxes[dup[:-1]]
        for k in rng.choice(n - 1, n // 16, replace=False):
            x, y = np.floor(rng.uniform(0, 150, 2))
            boxes[k] = (x, y, x + 9, y + 9)
            boxes[k + 1] = (x, y, x + 9, y + 6)
        a, b = near_threshold_pairs(rng, n // 4)
        boxes[0:n // 2:2], boxes[1:n // 2:2] = a, b
    return boxes


@pytest.mark.parametrize('n', [512, 1024])
def test_masks_word_for_word(n):
    rng = np.random.RandomState(n)
    boxes = make_boxes(rng, n)
    want_xla = np.asarray(jnms.build_suppression_masks(jnp.asarray(boxes),
                                                       0.7, block=512))
    want_pallas = np.asarray(jnms.build_suppression_masks_pallas(
        jnp.asarray(boxes), 0.7, tile=512, interpret=True))
    np.testing.assert_array_equal(want_pallas, want_xla)
    batch = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()]))
    got = tnms.build_suppression_masks_cuda(batch, 0.7).numpy()
    assert got.shape == (2, n // 32, n) and got.dtype == np.int32
    np.testing.assert_array_equal(got[0], want_xla)
    np.testing.assert_array_equal(
        got[1], np.asarray(jnms.build_suppression_masks(
            jnp.asarray(boxes[::-1].copy()), 0.7, block=512)))
    # the exact-0.7 pairs are not suppressed (IoU > t is strict)
    assert got.any()


def test_mask_builder_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tnms.build_suppression_masks_cuda(torch.zeros(2, 100, 4), 0.7)
    with pytest.raises(TypeError):
        tnms.build_suppression_masks_cuda(
            torch.zeros(2, 64, 4, dtype=torch.float64), 0.7)


@pytest.mark.parametrize('n,thresh', [(300, 0.3), (700, 0.7), (1000, 0.5)])
def test_keep_sets_equal_greedy_oracle(n, thresh):
    rng = np.random.RandomState(n)
    boxes = make_boxes(rng, n, with_ties=False)
    scores = rng.permutation(n).astype(np.float32) / n   # distinct
    valid = rng.uniform(size=n) > 0.1
    dets = np.concatenate([boxes, scores[:, None]], 1)[valid]
    want = np.flatnonzero(valid)[jnms.nms_py(dets, thresh)]
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    tv = torch.from_numpy(valid)
    for max_out in (len(want), 50):
        keep, mask = tnms.nms_fixpoint(tb, ts, thresh, max_out, valid=tv)
        np.testing.assert_array_equal(keep.numpy()[mask.numpy()],
                                      want[:max_out])
        keep, mask = tnms.nms_packed(tb[None], ts[None], thresh, max_out,
                                     valid=tv[None])
        np.testing.assert_array_equal(keep[0].numpy()[mask[0].numpy()],
                                      want[:max_out])
    # presorted path: sort first, then indices are sorted positions
    order = np.argsort(-np.where(valid, scores, -np.inf), kind='stable')
    keep, mask = tnms.nms_packed(tb[order][None], ts[order][None], thresh,
                                 len(want), valid=tv[order][None],
                                 presorted=True)
    np.testing.assert_array_equal(order[keep[0].numpy()[mask[0].numpy()]],
                                  want)


def test_fixpoint_matches_jax_batched_with_ties():
    rng = np.random.RandomState(11)
    boxes = np.stack([make_boxes(rng, 200) for _ in range(3)])
    scores = np.round(rng.uniform(size=(3, 200)), 1).astype(np.float32)
    valid = rng.uniform(size=(3, 200)) > 0.2
    keep, mask = tnms.nms_fixpoint(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.3, 100,
                                   valid=torch.from_numpy(valid))
    for b in range(3):
        jk, jm = jnms.nms_fixpoint(jnp.asarray(boxes[b]),
                                   jnp.asarray(scores[b]), 0.3, 100,
                                   valid=jnp.asarray(valid[b]))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jm))


def test_proposal_layer_matches_jax_with_ties():
    from tpudenoise.ops.anchors import anchor_grid as j_anchor_grid
    from tpudenoise.ops.proposal import proposal_layer as j_proposal_layer
    from tpudenoise_torch.ops.anchors import anchor_grid
    from tpudenoise_torch.ops.proposal import proposal_layer
    fh, fw = 12, 16
    anchors = anchor_grid(fh, fw)
    np.testing.assert_array_equal(anchors.numpy(),
                                  np.asarray(j_anchor_grid(fh, fw)))
    k = anchors.shape[0]
    rng = np.random.RandomState(4)
    # coarse scores: many exact ties among the candidates
    scores = (np.round(rng.uniform(size=(2, k)) * 16) / 16).astype(np.float32)
    deltas = (rng.randn(2, k, 4) * 0.2).astype(np.float32)
    im_hw = np.asarray([[180, 250], [192, 256]], np.float32)
    rois, rs, mask = proposal_layer(
        torch.from_numpy(scores), torch.from_numpy(deltas), anchors,
        torch.from_numpy(im_hw), 0.7, 512, 100)
    for b in range(2):
        jr, js, jm = j_proposal_layer(
            jnp.asarray(scores[b]), jnp.asarray(deltas[b]),
            jnp.asarray(anchors.numpy()), jnp.asarray(im_hw[b]), 0.7, 512,
            100)
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(rs[b].numpy(), np.asarray(js))
        np.testing.assert_allclose(rois[b].numpy(), np.asarray(jr),
                                   atol=1e-4, rtol=0)


def test_proposal_top_layer_matches_jax():
    from tpudenoise.ops.proposal import proposal_top_layer as j_top
    from tpudenoise_torch.ops.anchors import anchor_grid
    from tpudenoise_torch.ops.proposal import proposal_top_layer
    anchors = anchor_grid(8, 10)
    k = anchors.shape[0]
    rng = np.random.RandomState(5)
    scores = (np.round(rng.uniform(size=(1, k)) * 8) / 8).astype(np.float32)
    deltas = (rng.randn(1, k, 4) * 0.2).astype(np.float32)
    im_hw = np.asarray([[100, 140]], np.float32)
    p, s, m = proposal_top_layer(torch.from_numpy(scores),
                                 torch.from_numpy(deltas), anchors,
                                 torch.from_numpy(im_hw), 300)
    jp, js, jm = j_top(jnp.asarray(scores[0]), jnp.asarray(deltas[0]),
                       jnp.asarray(anchors.numpy()), jnp.asarray(im_hw[0]),
                       300)
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(js))
    np.testing.assert_allclose(p[0].numpy(), np.asarray(jp), atol=1e-4,
                               rtol=0)


def _pair_terms(a, b):
    """inter and den of box pairs, f32, in the reference's operation
    order (the kernel's)."""
    f = np.float32
    with np.errstate(all='ignore'):
        ba = (a[:, 2] - a[:, 0] + f(1)) * (a[:, 3] - a[:, 1] + f(1))
        area = (b[:, 2] - b[:, 0] + f(1)) * (b[:, 3] - b[:, 1] + f(1))
        iw = np.maximum(f(0), np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]) + f(1))
        ih = np.maximum(f(0), np.minimum(a[:, 3], b[:, 3])
                        - np.maximum(a[:, 1], b[:, 1]) + f(1))
        inter = iw * ih
        return inter, (ba + area) - inter


def _degenerate_pairs(rng, k):
    """Zero-width and inverted boxes (den 0 or negative), huge and
    infinite coordinates (den inf or NaN), tiny boxes (den subnormal)."""
    f = np.float32
    x, y = rng.uniform(0, 100, (2, k)).astype(f)
    w, h = rng.uniform(-3, 3, (2, k)).astype(f)
    a = np.stack([x, y, x + w, y + h], 1)
    b = a + rng.uniform(-2, 2, (k, 4)).astype(f)
    b[: k // 4, 2] = f(np.inf)
    b[k // 4: k // 2, 0] = f(3e38)
    a[k // 2: 3 * k // 4] = np.stack([x, y, x - f(1) + f(1e-30),
                                      y - f(1) + f(1e-30)], 1)[k // 2:
                                                               3 * k // 4]
    a[3 * k // 4:, 3] = f(np.nan)
    return a, b


@pytest.mark.parametrize('thresh', [0.3, 0.5, 0.7])
def test_divide_free_predicate_equals_f32_division(thresh):
    """`iou_exceeds` (the kernel's predicate in numpy) against the f32
    divide on near-threshold pairs, on quotients one ulp either side of
    the threshold, and on degenerate boxes."""
    rng = np.random.RandomState(int(thresh * 10))
    f = np.float32
    a, b = near_threshold_pairs(rng, 200000, thresh)
    c, d = _degenerate_pairs(rng, 40000)
    inter, den = (np.concatenate(v) for v in zip(_pair_terms(a, b),
                                                 _pair_terms(c, d)))
    # dens that put inter/den on, and one ulp beside, the threshold
    near = (inter[:200000] / f(thresh)).astype(f)
    inter = np.concatenate([inter, np.tile(inter[:200000], 3)])
    den = np.concatenate([den, near, np.nextafter(near, f(np.inf)),
                          np.nextafter(near, f(-np.inf))])
    with np.errstate(all='ignore'):
        want = inter / den > f(thresh)
    got = tnms.iou_exceeds(inter, den, thresh)
    np.testing.assert_array_equal(got, want)
    assert 0.2 < want.mean() < 0.8
    assert (den <= 0).any() and (~np.isfinite(den)).any()


def _walk_np(words, valid, max_out):
    """The walk kernel's strips in numpy: warp 0's in-order decision from
    the diagonal words, then the kept rows ORed into the removed bits of
    the later columns; stops once max_out boxes are kept."""
    nw, n = words.shape
    u = words.view(np.uint32)
    removed = np.zeros(n, bool)
    keep = []
    for s in range(nw):
        kept = 0
        for c in range(32):
            j = 32 * s + c
            if valid[j] and not removed[j] and not (u[s, j] & kept):
                kept |= 1 << c
        keep += [32 * s + c for c in range(32) if kept >> c & 1]
        if len(keep) >= max_out:
            break
        removed |= (u[s] & np.uint32(kept)) != 0
    return (keep + [-1] * max_out)[:max_out]


@pytest.mark.parametrize('n,thresh,max_out', [(512, 0.7, 300),
                                              (512, 0.7, 512),
                                              (320, 0.3, 100)])
def test_walk_equals_fixpoint(n, thresh, max_out):
    """The greedy walk's algorithm (numpy) and `greedy_keep`'s plain
    version give the same positions on packed words with ties."""
    rng = np.random.RandomState(n + max_out)
    boxes = torch.from_numpy(np.stack([make_boxes(rng, n) for _ in range(2)]))
    valid = torch.from_numpy(rng.uniform(size=(2, n)) > 0.1)
    words = tnms.build_suppression_masks_cuda(boxes, thresh)
    got = tnms.greedy_keep(words, valid, max_out)
    for p in range(2):
        np.testing.assert_array_equal(
            got[p].numpy(), _walk_np(words[p].numpy(), valid[p].numpy(),
                                     max_out))
    with pytest.raises(ValueError):
        tnms.greedy_keep(words[:, 1:], valid, max_out)


def _postprocess_inputs(seed, b=2, c=4, r=300):
    """Per-class NMS inputs at postprocess shapes: (b, c, r) with tied
    scores, duplicate and near-threshold boxes, and invalid entries."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([np.stack([make_boxes(rng, r) for _ in range(c)])
                      for _ in range(b)])
    scores = (np.round(rng.uniform(size=(b, c, r)) * 8) / 8).astype(
        np.float32)
    valid = rng.uniform(size=(b, c, r)) > 0.25
    valid[0, 1] = False                      # a class with nothing valid
    return boxes, scores, valid


def test_packed_fixpoint_takes_one_unbatched_problem():
    """One (N, 4) problem with no validity mask (the library smoke's
    call, `examples/smoke.py`): the packed route equals the dense one."""
    boxes, scores, _ = _postprocess_inputs(5)
    args = (torch.from_numpy(boxes[0, 0]), torch.from_numpy(scores[0, 0]),
            0.7, 100)
    pk, pm = tnms.nms_fixpoint_packed(*args)
    dk, dm = tnms.nms_fixpoint(*args)
    assert pk.shape == (100,) and pm.sum() > 0
    np.testing.assert_array_equal(pk.numpy(), dk.numpy())
    np.testing.assert_array_equal(pm.numpy(), dm.numpy())


@pytest.mark.parametrize('thresh', [0.3, 0.7])
def test_packed_fixpoint_equals_dense_and_oracle(thresh):
    """`nms_fixpoint_packed` (the card's route: pad 300 -> 320, kernel 3,
    the walk) equals the dense route at postprocess shapes, and both keep
    what `nms_py` keeps, in order, for the first 100."""
    boxes, scores, valid = _postprocess_inputs(int(thresh * 10))
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), thresh, 100)
    dk, dm = tnms.nms_fixpoint(*args, valid=torch.from_numpy(valid))
    pk, pm = tnms.nms_fixpoint_packed(*args, valid=torch.from_numpy(valid))
    assert pk.shape == (2, 4, 100) and pk.dtype == torch.int32
    np.testing.assert_array_equal(pk.numpy(), dk.numpy())
    np.testing.assert_array_equal(pm.numpy(), dm.numpy())
    assert not pm[0, 1].any() and pm.sum() > 0
    for bi in range(2):
        for ci in range(4):
            v = valid[bi, ci]
            # nms_py orders ties by reversed index; the port (as the
            # reference's nms_fixpoint) by index: break them the same way,
            # and stay in f32 as the port's IoU does
            s = scores[bi, ci] - (np.arange(300) * 1e-6).astype(np.float32)
            dets = np.concatenate([boxes[bi, ci], s[:, None]], 1)[v]
            assert dets.dtype == np.float32
            want = np.flatnonzero(v)[jnms.nms_py(dets, thresh)][:100]
            got = pk[bi, ci].numpy()[pm[bi, ci].numpy()]
            np.testing.assert_array_equal(got, want)
