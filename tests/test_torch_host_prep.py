"""Host prep (`device_prep=False`, `cli.test --host-prep`) in the port,
against the JAX package, on the CPU.

* `utils.blob.prep_im_for_blob` and `pad_to_bucket` bit-equal to the JAX
  package's (`tpudenoise.utils.blob.prep_im_for_blob`,
  `tpudenoise.models.faster_rcnn.pad_to_bucket`) at scale 1 and at
  scales that interpolate; `eval.harness.host_prep` over a noisy chunk
  of two shapes bit-equal to the JAX harness's host loop.
* `test_net_batched(device_prep=False)` against the JAX package's, on
  `tests/test_torch_slice.py`'s fixture (scale 150/160: cv2 interpolates)
  at that file's tolerance.
* Without cv2 (the GPU machine has none) host prep raises an ImportError
  naming it; `cli.test --host-prep` goes to `test_net_batched` with
  device_prep=False at any --eval-batch, as the JAX CLI routes it.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_slice import env, match_row  # noqa: F401


@pytest.mark.parametrize('shape,target,max_size', [
    ((120, 160), 120, 160), ((120, 160), 100, 160), ((75, 101), 150, 1000),
    ((375, 500), 600, 1000)])
def test_prep_im_for_blob_bit_equal(shape, target, max_size):
    from tpudenoise.models.faster_rcnn import pad_to_bucket as j_pad
    from tpudenoise.utils.blob import prep_im_for_blob as j_prep
    from tpudenoise_torch.utils.blob import derive_bucket, pad_to_bucket
    from tpudenoise_torch.utils.blob import prep_im_for_blob
    rng = np.random.RandomState(sum(shape) + target)
    im = rng.randint(0, 256, (*shape, 3)).astype(np.float32)
    means = np.array([[[102.9801, 115.9465, 122.7717]]], np.float32)
    want, want_s = j_prep(im, means, target, max_size)
    got, got_s = prep_im_for_blob(im, means, target, max_size)
    assert got_s == want_s
    np.testing.assert_array_equal(got, want)
    bucket = derive_bucket(target, max_size, portrait=shape[0] > shape[1])
    (gp, ghw), (wp, whw) = pad_to_bucket(got, bucket), j_pad(want, bucket)
    assert ghw == whw
    np.testing.assert_array_equal(gp, wp)


def test_host_prep_chunk_bit_equal():
    """harness.host_prep over a chunk edge-padded to its noise bucket:
    each image cropped to its raw size, then the JAX host loop's
    prep_im_for_blob and pad_to_bucket."""
    from tpudenoise.models.faster_rcnn import pad_to_bucket as j_pad
    from tpudenoise.utils.blob import prep_im_for_blob as j_prep
    from tpudenoise_torch.core.config import default_config
    from tpudenoise_torch.eval.harness import host_prep
    # the JAX harness's host loop takes the means in f32
    means = np.asarray(default_config().PIXEL_MEANS, np.float32)
    shapes = [(90, 120), (100, 130)]
    noisy = np.random.RandomState(3).randint(0, 256, (2, 100, 130, 3)).astype(
        np.float32)
    got = host_prep(torch.from_numpy(noisy), shapes, 96, 160, (128, 160),
                    means)
    for j, (h, w) in enumerate(shapes):
        im, _ = j_prep(noisy[j, :h, :w], means, 96, 160)
        np.testing.assert_array_equal(got[j].numpy(),
                                      j_pad(im, (128, 160))[0])


def test_test_net_batched_host_prep_matches_jax(env, monkeypatch):  # noqa
    matched, total = match_row(env, 'sap_median_var0.4', monkeypatch,
                               harness_kw={'device_prep': False})
    assert total > 0 and matched / total >= 0.95, (matched, total)


def test_host_prep_needs_cv2(monkeypatch):
    from tpudenoise_torch.eval.harness import host_prep
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        host_prep(torch.zeros(1, 8, 8, 3), [(8, 8)], 8, 8, (32, 32),
                  [0.0, 0.0, 0.0])


@pytest.mark.parametrize('eval_batch', [1, 4])
def test_cli_host_prep_routes_to_batched(eval_batch, monkeypatch, tmp_path):
    import copy

    import tpudenoise_torch.core.config as tconfig
    import types

    import tpudenoise_torch.data.factory as factory
    from tpudenoise_torch.cli import test as ttest
    from tpudenoise_torch.eval import harness
    seen = []
    monkeypatch.setattr(factory, 'get_imdb',
                        lambda name: types.SimpleNamespace(
                            num_classes=2, competition_mode=lambda on: None))
    monkeypatch.setattr(harness, 'test_net_batched',
                        lambda *a, **k: seen.append(k) or [0.5])
    monkeypatch.setattr(harness, 'test_net', lambda *a, **k: 1 / 0)
    saved = copy.deepcopy(tconfig.cfg)
    try:
        aps = ttest.main(['--net', 'mobile', '--imdb', 'rrData_2021_test',
                          '--host-prep', '--eval-batch', str(eval_batch),
                          '--device', 'cpu', '--set', 'ROOT_DIR',
                          str(tmp_path)])
    finally:
        tconfig.cfg.clear()
        tconfig.cfg.update(saved)
    assert aps == [0.5]
    assert seen[0]['device_prep'] is False
    assert seen[0]['eval_batch'] == eval_batch
