"""The port's `utils/visualization.py` against the JAX package's on the
CPU:

* `class_color` and `image_grid` equal;
* `draw_bounding_boxes` (numpy) equal to the JAX one (PIL) everywhere but
  the label glyphs, the one stated deviation: the port draws the class id
  from its own 5x7 digit table, PIL in its default font.  Both labels'
  cells (PIL's `textbbox` and the port's `label_extent`) are masked out;
  the outlines must match pixel for pixel, boxes at image edges, narrow
  boxes and an im_info rescale included.  PIL's `rectangle(width=2)`
  alone is held against `draw_rectangle` on fuzzed float boxes;
* the solver's gt summary (`train/gt_image`) of the same batch, the
  port's `_log_gt_image_summary` against the JAX solver's.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpudenoise.utils import visualization as jvis
from tpudenoise_torch.utils import visualization as vis


def test_class_color_matches():
    for c in range(300):
        assert vis.class_color(c) == jvis.class_color(c)


@pytest.mark.parametrize('cols,pad', [(4, 2), (3, 0), (1, 5)])
def test_image_grid_matches(cols, pad):
    rng = np.random.RandomState(cols + pad)
    ims = [rng.uniform(-20, 280, (rng.randint(5, 30), rng.randint(5, 40),
                                  rng.choice([3, 4])))
           for _ in range(7)]
    got, want = vis.image_grid(ims, cols, pad), jvis.image_grid(ims, cols,
                                                                 pad)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_draw_rectangle_matches_pil():
    from PIL import Image, ImageDraw
    rng = np.random.RandomState(0)
    for _ in range(3000):
        img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
        x0, y0 = rng.uniform(-10, 45), rng.uniform(-10, 35)
        w = rng.uniform(0, 5) if rng.rand() < 0.5 else rng.uniform(0, 40)
        h = rng.uniform(0, 5) if rng.rand() < 0.5 else rng.uniform(0, 40)
        box = (x0, y0, x0 + w, y0 + h)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        pil = Image.fromarray(img.copy())
        ImageDraw.Draw(pil).rectangle(box, outline=color, width=2)
        got = img.copy()
        vis.draw_rectangle(got, box, color)
        np.testing.assert_array_equal(got, np.asarray(pil), err_msg=box)
    with pytest.raises(ValueError):
        vis.draw_rectangle(img, (5, 5, 4, 9), (1, 2, 3))


def _label_mask(shape, boxes, scale):
    """True on both drawings' label cells."""
    from PIL import Image, ImageDraw
    draw = ImageDraw.Draw(Image.new('RGB', (shape[1], shape[0])))
    mask = np.zeros(shape[:2], bool)
    for box in boxes:
        x1, y1 = float(box[0]) / scale, float(box[1]) / scale
        text, at = str(int(box[4])), (x1 + 2, max(y1 - 12, 0))
        for x0, y0, xe, ye in (draw.textbbox(at, text),
                               vis.label_extent(*at, text)):
            mask[max(int(y0), 0):max(int(ye) + 1, 0),
                 max(int(x0), 0):max(int(xe) + 1, 0)] = True
    return mask


def _boxes(rng, h, w, n):
    x1, y1 = rng.uniform(-5, w - 4, n), rng.uniform(-5, h - 4, n)
    bw, bh = rng.uniform(0, 60, n), rng.uniform(0, 60, n)
    cls = rng.choice([0, 1, 7, 12, 105], n)
    return np.stack([x1, y1, x1 + bw, y1 + bh, cls], 1).astype(np.float32)


@pytest.mark.parametrize('scale', [None, 1.6])
def test_draw_bounding_boxes_matches_outside_the_labels(scale):
    rng = np.random.RandomState(4 if scale else 5)
    h, w = 90, 130
    img = rng.uniform(-30, 290, (h, w, 3))
    boxes = _boxes(rng, h, w, 12)
    boxes[:, :4] *= scale or 1.0
    info = None if scale is None else np.array([h, w, scale], np.float32)
    got = vis.draw_bounding_boxes(img, boxes, info)
    want = jvis.draw_bounding_boxes(img, boxes, info)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    mask = _label_mask(img.shape, boxes, scale or 1.0)
    assert 0 < mask.mean() < 0.5
    np.testing.assert_array_equal(got[~mask], want[~mask])
    # the outlines did change pixels, and the labels are drawn in colour
    base = np.clip(img, 0, 255).astype(np.uint8)
    assert (got != base).any(-1)[~mask].sum() > 100
    for box in boxes:
        x1, y1 = float(box[0]) / (scale or 1.0), float(box[1]) / (scale or 1)
        x0, y0, xe, ye = vis.label_extent(x1 + 2, max(y1 - 12, 0),
                                          str(int(box[4])))
        cell = got[max(y0, 0):max(ye, 0), max(x0, 0):max(xe, 0)]
        color = vis.class_color(int(box[4]))
        if x0 >= 0 and xe <= w and ye <= h:
            assert (cell == color).all(-1).any()


def test_solver_gt_summary_matches_jax():
    """The gt summary of the same batch through both solvers' method."""
    from tpudenoise.core.config import default_config as jdefault
    from tpudenoise.train.solver import Solver as JSolver
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.train.solver import Solver
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    b, hb, wb = 2, 96, 128
    means = np.asarray(default_config().PIXEL_MEANS, np.float32)
    image = (rng.randint(0, 256, (b, hb, wb, 3)).astype(np.float32)
             - means.reshape(3))
    image[0, 80:] = 0.0                  # the bucket pad, zero after means
    im_info = np.array([[80, 120, 1.0], [96, 128, 1.0]], np.float32)
    gt_boxes = np.zeros((b, 6, 5), np.float32)
    gt_boxes[0, :4] = _boxes(rng, 80, 120, 4)
    gt_boxes[0, :4, :4] = np.clip(gt_boxes[0, :4, :4], 0, 119)
    gt_boxes[0, :4, 4] = [1, 1, 1, 1]
    gt_mask = np.zeros((b, 6), bool)
    gt_mask[0, :3] = True
    got, want = {}, {}

    def sink(into):
        return lambda tag, img, step: into.update(tag=tag, img=img,
                                                  step=step)

    port = SimpleNamespace(cfg=default_config(), logger=SimpleNamespace(
        active_sinks=True, log_image=sink(got)))
    Solver._log_gt_image_summary(port, {
        'image': torch.from_numpy(image), 'im_info': torch.from_numpy(
            im_info), 'gt_boxes': torch.from_numpy(gt_boxes),
        'gt_mask': torch.from_numpy(gt_mask)}, 7)
    jax_ = SimpleNamespace(cfg=jdefault(), logger=SimpleNamespace(
        _tb=object(), _wandb=None, log_image=sink(want)))
    JSolver._log_gt_image_summary(jax_, {
        'image': jnp.asarray(image), 'im_info': jnp.asarray(im_info),
        'gt_boxes': jnp.asarray(gt_boxes), 'gt_mask': jnp.asarray(gt_mask)},
        7)
    assert got['tag'] == want['tag'] == 'train/gt_image'
    assert got['step'] == want['step'] == 7
    a, w_ = got['img'], np.asarray(want['img'])
    assert a.shape == w_.shape == (80, 120, 3)
    mask = _label_mask(a.shape, gt_boxes[0][gt_mask[0]], 1.0)
    np.testing.assert_array_equal(a[~mask], w_[~mask])
    assert (a != np.clip(image[0, :80, :120, ::-1] + means.reshape(3), 0,
                         255).astype(np.uint8)).any(-1).sum() > 50
