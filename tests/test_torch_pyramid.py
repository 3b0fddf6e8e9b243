"""The multi-scale TEST.SCALES pyramid: the port's
`postprocess_detections_pyramid` (batched over images) against the JAX
package's (one image at a time) and `tests/test_multiscale.py`'s cases,
and a two-scale `test_net_batched` against the JAX package's, on the CPU.

* random levels: boxes, scores and masks as JAX's to 1e-5 (f32 decode,
  the same keep decisions);
* a one-level pyramid equals `postprocess_detections` exactly;
* the hand-checked case: each level decodes through its own scale, an
  overlapping weaker candidate of the other level is suppressed, a
  disjoint one kept;
* the two-scale loop (scales 120 and 150, MAX_SIZE 200, the 160x200
  fixture; noise once a chunk, one prep and forward per scale) at
  `tests/test_torch_slice.py`'s tolerance: >= 95% of the JAX detections
  have a port twin within 0.5, counts within one.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_rrdata_fixture
from tests.test_torch_slice import match_row
from tpudenoise_torch.eval.harness import (postprocess_detections,
                                           postprocess_detections_pyramid)


def _levels(rng, b, s, r, c):
    rois = np.zeros((b, s, r, 4), np.float32)
    x1 = rng.rand(b, s, r) * 50
    y1 = rng.rand(b, s, r) * 40
    rois[..., 0], rois[..., 1] = x1, y1
    rois[..., 2] = x1 + 10 + rng.rand(b, s, r) * 30
    rois[..., 3] = y1 + 10 + rng.rand(b, s, r) * 30
    probs = rng.dirichlet(np.ones(c), size=(b, s, r)).astype(np.float32)
    preds = (rng.randn(b, s, r, 4 * c) * 0.1).astype(np.float32)
    mask = rng.rand(b, s, r) > 0.2
    scale = rng.choice([0.8, 1.0, 1.5, 2.0], (b, s)).astype(np.float32)
    infos = np.stack([np.round(90 * scale), np.round(120 * scale), scale],
                     -1).astype(np.float32)
    return rois, mask, probs, preds, infos


@pytest.mark.parametrize('b,s,r,c', [(2, 2, 16, 3), (3, 3, 24, 5),
                                     (1, 2, 40, 81)])
def test_pyramid_postprocess_matches_jax(b, s, r, c):
    from tpudenoise.eval.harness import \
        postprocess_detections_pyramid as jax_pyramid
    rng = np.random.RandomState(b * 100 + c)
    levels = _levels(rng, b, s, r, c)
    got = postprocess_detections_pyramid(
        *(torch.from_numpy(a) for a in levels), c, 0.3, 0.05,
        max_per_class=8)
    for i in range(b):
        want = jax_pyramid(*(jnp.asarray(a[i]) for a in levels), c, 0.3,
                           0.05, max_per_class=8)
        wb, ws, wm = (np.asarray(x) for x in want)
        gb, gs, gm = (x[i].numpy() for x in got)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
        np.testing.assert_allclose(gs[gm], ws[wm], rtol=0, atol=1e-6)


def test_pyramid_single_level_matches_flat():
    rng = np.random.RandomState(0)
    rois, mask, probs, preds, infos = (torch.from_numpy(a) for a in _levels(
        rng, 2, 1, 16, 3))
    flat = postprocess_detections(rois[:, 0], mask[:, 0], probs[:, 0],
                                  preds[:, 0], infos[:, 0], 3, 0.3, 0.01,
                                  max_per_class=8)
    pyr = postprocess_detections_pyramid(rois, mask, probs, preds, infos, 3,
                                         0.3, 0.01, max_per_class=8)
    for a, b in zip(flat, pyr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pyramid_postprocess_semantics():
    """`tests/test_multiscale.py`'s case: level 0 at scale 2, roi (20, 20,
    60, 60) -> (10, 10, 30, 30), score .9; level 1 at scale 1, an
    overlapping roi (score .6, suppressed) and a disjoint one (.7,
    kept)."""
    rois = torch.tensor([[[[20., 20., 60., 60.], [0., 0., 0., 0.]],
                          [[11., 11., 31., 31.], [50., 50., 70., 70.]]]])
    masks = torch.tensor([[[True, False], [True, True]]])
    probs = torch.tensor([[[[0.1, 0.9], [0., 0.]],
                           [[0.4, 0.6], [0.3, 0.7]]]])
    preds = torch.zeros((1, 2, 2, 8))
    infos = torch.tensor([[[120., 160., 2.0], [60., 80., 1.0]]])
    boxes, scores, mask = postprocess_detections_pyramid(
        rois, masks, probs, preds, infos, num_classes=2, nms_thresh=0.3,
        score_thresh=0.05, max_per_class=4)
    kept = scores[0, 0][mask[0, 0]].numpy()
    np.testing.assert_allclose(sorted(kept, reverse=True), [0.9, 0.7],
                               atol=1e-6)
    best = boxes[0, 0][mask[0, 0]][int(np.argmax(kept))].numpy()
    np.testing.assert_allclose(best, [10., 10., 31., 31.], atol=1e-4)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    from tpudenoise.core.config import default_config as jax_default_config
    from tpudenoise_torch.core.config import default_config
    root = str(tmp_path_factory.mktemp('tpyramid'))
    make_rrdata_fixture(root, n_test=3, size=(160, 200))
    jc, tc = jax_default_config(), default_config()
    for c in (jc, tc):
        c.DATA_DIR = c.ROOT_DIR = root
        c.EXP_DIR = 'pyramid'
        c.TEST.SCALES = (120, 150)
        c.TEST.MAX_SIZE = 200
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 32
    return jc, tc


@pytest.mark.parametrize('noise', ['original', 'sap_median_var0.4'])
def test_two_scale_test_net_batched_matches_jax(env, noise, monkeypatch):
    from tpudenoise_torch.eval import harness
    calls = []
    pyr = harness.postprocess_detections_pyramid
    monkeypatch.setattr(harness, 'postprocess_detections_pyramid',
                        lambda *a, **k: calls.append(a[0].shape)
                        or pyr(*a, **k))
    matched, total = match_row(env, noise, monkeypatch)
    assert calls == [(3, 2, 32, 4)], calls
    assert total > 0 and matched / total >= 0.95, (matched, total)
