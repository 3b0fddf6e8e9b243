"""Data parallelism (counterpart of `tpudenoise/parallel/dp.py`): the
parameters replicate, the batch's leading dimension splits over the
mesh's 'data' axis, and each rank computes its rows.

Each wrapper takes the global batch, as the JAX package's does, and
returns this rank's share of the unsharded call's result;
`core.mesh.gather_batch` joins the shares into that result.
"""

from __future__ import annotations

from tpudenoise_torch.core import mesh as M


def replicate(mesh, tree):
    """Rank 0's tensors on every rank (a broadcast, in place)."""
    return M.replicated(mesh, tree)


def shard_batch(mesh, tree, axis: str = 'data'):
    """This rank's slice of each leaf's leading dimension over `axis`."""
    return M.shard_batch(mesh, tree, axis)


def dp_inference(model, mesh):
    """fn(params, images, im_infos) -> this rank's rows of
    model.forward_test(params, images, im_infos).  params must be the
    same on every rank (`replicate` them once)."""
    def wrapped(params, images, im_infos):
        images, im_infos = shard_batch(mesh, (images, im_infos))
        return model.forward_test(params, images, im_infos)

    return wrapped


def dp_noise_pipeline(pipe, mesh):
    """fn(key, images) -> this rank's rows of pipe(key, images): the
    whole batch's draws, the noise on this rank's images only."""
    def wrapped(key, images):
        rows = M.batch_rows(mesh, images.shape[0])
        return pipe.share(key, images[rows], rows.start, images.shape[0])

    return wrapped
