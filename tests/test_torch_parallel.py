"""The port's spatial and data parallelism (`tpudenoise_torch/parallel/`)
against the JAX package's `tpudenoise/parallel/`, on the CPU.

One group of four gloo ranks (subprocesses, `tests/torch_ranks.py`)
runs every check and writes the gathered results; the JAX side runs
in-process on the 8-device CPU mesh that `conftest.py` sets up, as
`tests/test_parallel.py` does:
* the spatial median, mean and gaussian on (2, 64, 48, 3), H split over
  the four ranks, bit-exact against `make_spatial_filter` on the JAX
  mesh (and both against the single-device stencils);
* a (2, 2) ('data', 'spatial') mesh, B over 'data' and H over
  'spatial': the median and the gaussian on (4, 32, 48, 3), bit-exact
  against the JAX (2, 2) mesh;
* `dp_noise_pipeline` over the four ranks, gathered, bit-exact against
  the JAX pipeline on sap (its Pallas kernel in interpret mode, the
  port's kernel's counterpart) and against the port's unsharded
  pipeline on the fused gaussian and a generic string;
* `dp_inference`'s gathered rows equal to one forward of the batch.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_ranks import run_ranks

RANKS = r'''
import os, sys
import numpy as np
import torch
from tpudenoise_torch.core import mesh as M, prng
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.noise.pipeline import make_pipeline
from tpudenoise_torch.parallel import dp, spatial

out_dir = sys.argv[1]
M.initialize_distributed(init_method=os.environ['TORCH_DIST_INIT'],
                         device='cpu')
mesh = M.make_mesh()
res = {}
for kind, seed in (('median', 0), ('mean', 1), ('gaussian', 1)):
    imgs = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (2, 64, 48, 3)).astype(np.float32))
    fn = spatial.make_spatial_filter(mesh, kind)
    block = spatial.spatial_block(mesh, imgs)
    assert block.shape == (2, 16, 48, 3)
    res['spatial_' + kind] = spatial.gather_spatial(mesh, fn(block))
mesh2 = M.make_mesh([2, 2], ['data', 'spatial'])
imgs = torch.from_numpy(np.random.RandomState(7).randint(
    0, 256, (4, 32, 48, 3)).astype(np.float32))
for kind in ('median', 'gaussian'):
    fn = spatial.make_spatial_filter(mesh2, kind, axis='spatial',
                                     batch_axis='data')
    block = spatial.spatial_block(mesh2, imgs, 'spatial', 'data')
    assert block.shape == (2, 16, 48, 3)
    res['mesh2d_' + kind] = spatial.gather_spatial(
        mesh2, fn(block), 'spatial', 'data')
imgs = torch.from_numpy(np.random.RandomState(2).randint(
    0, 256, (8, 32, 48, 3)).astype(np.float32))
for noise in ('sap_median_var0.4', 'gaussian_gaus_blur_var0.1',
              'uniform_mean_var0.6'):
    pipe = make_pipeline(noise, mode='TRAIN')
    share = dp.dp_noise_pipeline(pipe, mesh)(prng.PRNGKey(0), imgs)
    assert share.shape == (2, 32, 48, 3)
    res['dp_' + noise] = M.gather_batch(mesh, share)
    res['one_' + noise] = pipe(prng.PRNGKey(0), imgs)
cfg = default_config()
cfg.TEST.RPN_PRE_NMS_TOP_N, cfg.TEST.RPN_POST_NMS_TOP_N = 64, 16
model = FasterRCNN('vgg16', num_classes=2, cfg=cfg, dtype=torch.float32)
params = dp.replicate(mesh, model.init(torch.Generator().manual_seed(
    M.rank()), image_shape=(32, 48)))
x = torch.from_numpy(np.random.RandomState(0).randn(8, 32, 48, 3).astype(
    np.float32) * 20)
infos = torch.tensor([[30., 45., 1.]] * 8)
out = dp.dp_inference(model, mesh)(params, x, infos)
assert out['cls_prob'].shape == (2, 16, 2)
got = M.gather_batch(mesh, out)
want = model.forward_test(params, x, infos)
for k in ('rois', 'cls_prob', 'bbox_pred'):
    res['dpinf_err_' + k] = (got[k] - want[k]).abs().max()
if M.rank() == 0:
    np.savez(os.path.join(out_dir, 'ranks.npz'),
             **{k: v.numpy() for k, v in res.items()})
torch.distributed.destroy_process_group()
assert 'jax' not in sys.modules
print('RANK_OK')
'''


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('parallel')
    outs = run_ranks(RANKS, 4, tmp, args=(str(tmp),))
    assert all('RANK_OK' in o for o in outs)
    return dict(np.load(tmp / 'ranks.npz'))


@pytest.fixture(scope='module')
def jax_mesh():
    from tpudenoise.core.mesh import make_mesh
    return make_mesh()


@pytest.mark.parametrize('kind,seed', [('median', 0), ('mean', 1),
                                       ('gaussian', 1)])
def test_spatial_filters_match_jax(ranks, jax_mesh, kind, seed):
    from tpudenoise.denoise.stencils import gaussian_blur3, mean3, median3
    from tpudenoise.parallel.spatial import make_spatial_filter
    imgs = np.random.RandomState(seed).randint(
        0, 256, (2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(make_spatial_filter(jax_mesh, kind)(
        jnp.asarray(imgs)))
    ref = {'median': median3, 'mean': mean3, 'gaussian': gaussian_blur3}
    np.testing.assert_array_equal(want, np.asarray(jax.vmap(ref[kind])(
        imgs)))
    np.testing.assert_array_equal(ranks['spatial_' + kind], want)


@pytest.mark.parametrize('kind', ['median', 'gaussian'])
def test_spatial_2d_mesh_matches_jax(ranks, kind):
    from tpudenoise.core.mesh import make_mesh
    from tpudenoise.parallel.spatial import make_spatial_filter
    mesh2d = make_mesh([2, 2], ['data', 'spatial'],
                       devices=jax.devices()[:4])
    imgs = np.random.RandomState(7).randint(
        0, 256, (4, 32, 48, 3)).astype(np.float32)
    want = np.asarray(make_spatial_filter(
        mesh2d, kind, axis='spatial', batch_axis='data')(jnp.asarray(imgs)))
    np.testing.assert_array_equal(ranks['mesh2d_' + kind], want)


def test_dp_noise_pipeline_matches_jax(ranks, jax_mesh, monkeypatch):
    import tpudenoise.noise.pallas_kernels as pk
    from tpudenoise.noise.pipeline import make_pipeline
    from tpudenoise.parallel.dp import dp_noise_pipeline
    jax.config.update('jax_threefry_partitionable', True)
    monkeypatch.setattr(pk, 'fused_sap_median_batched', functools.partial(
        pk.fused_sap_median_batched, interpret=True))
    imgs = jnp.asarray(np.random.RandomState(2).randint(
        0, 256, (8, 32, 48, 3)).astype(np.float32))
    pipe = make_pipeline('sap_median_var0.4', mode='TRAIN', use_pallas=True)
    want = np.asarray(pipe(jax.random.PRNGKey(0), imgs))
    np.testing.assert_array_equal(ranks['dp_sap_median_var0.4'], want)
    # the JAX package's own sharded call gives the same (its XLA route)
    xla = make_pipeline('sap_median_var0.4', mode='TRAIN')
    np.testing.assert_array_equal(
        np.asarray(dp_noise_pipeline(xla, jax_mesh)(jax.random.PRNGKey(0),
                                                    imgs)),
        np.asarray(xla(jax.random.PRNGKey(0), imgs)))


@pytest.mark.parametrize('noise', ['gaussian_gaus_blur_var0.1',
                                   'uniform_mean_var0.6'])
def test_dp_noise_pipeline_equals_unsharded(ranks, noise):
    np.testing.assert_array_equal(ranks['dp_' + noise],
                                  ranks['one_' + noise])


def test_dp_inference_rows(ranks):
    """Each rank's forward of its rows, gathered, against one forward of
    the batch (the same params, replicated from rank 0): convolutions of
    2 and 8 images sum alike in f32 to rounding."""
    for k in ('rois', 'cls_prob', 'bbox_pred'):
        assert ranks['dpinf_err_' + k] <= 1e-3, k
