"""The port's NMS against the JAX package: packed suppression words word
for word (integer output, so exact), keep sets equal to the JAX package's
py_cpu_nms oracle, and proposal_layer equal to JAX's on identical inputs, tied
scores included (keep indices exact, rois to 1e-4 px)."""

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
