"""Spatial (image-plane) sharding of the 3x3 stencils (counterpart of
`tpudenoise/parallel/spatial.py`): images split along H over a mesh
axis, each rank filters its rows with one halo row from each neighbour,
exchanged by `dist.batch_isend_irecv` on that axis's process group.

At the global image edges the halo is the border the single-device
stencil uses: the median's edge rows (cv2 BORDER_REPLICATE) and the mean's
and gaussian's reflect-101 (virtual row -1 mirrors row 1).  The stencil is
`denoise.stencils`' own, run on the block with its halo rows and cropped
back, so each output row sees the same nine values as on one device: the
results are bit-equal to the unsharded stencils (the median selects
values; the mean rounds half to even and the gaussian half up, inside the
stencils, as `spatial.py`'s rounders do).

gloo does not send or receive CUDA tensors (one aborted the process on
an H100 with torch 2.11): under gloo (ranks sharing a GPU) the halo rows
go through host memory, one row of each image a neighbour; NCCL sends
them on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpudenoise_torch.core import mesh as M
from tpudenoise_torch.denoise import stencils

_STENCILS = {'median': (stencils.median3, 'edge'),
             'mean': (stencils.mean3, 'reflect101'),
             'gaussian': (stencils.gaussian_blur3, 'reflect101')}


def exchange_halo(block: torch.Tensor, group, border: str = 'edge'):
    """block: this rank's rows (B, Hloc, W, C) of images split along H
    over `group` in rank order.  Returns (above, below), one row each:
    the neighbours' edge rows, or at the global edges `border`'s row
    ('edge': the block's own edge row; 'reflect101': the row next to
    it)."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    staged = block.is_cuda and dist.get_backend(group) == 'gloo'
    host = (lambda t: t.cpu()) if staged else (lambda t: t)
    top = host(block[:, :1].contiguous())
    bot = host(block[:, -1:].contiguous())
    above, below = torch.empty_like(top), torch.empty_like(bot)
    ops = []
    if i > 0:
        peer = dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, top, peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if i < n - 1:
        peer = dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, bot, peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    edge = border == 'edge'
    above = (block[:, :1] if edge else block[:, 1:2]) if i == 0 \
        else above.to(block.device)
    below = (block[:, -1:] if edge else block[:, -2:-1]) if i == n - 1 \
        else below.to(block.device)
    return above, below


def make_spatial_filter(mesh, kind: str = 'median', axis: str = 'data',
                        batch_axis: str | None = None):
    """fn(block) filtering this rank's block of (B, H, W, 3) u8-domain
    float images: rows `spatial_block` gives, H split over `axis` (and B
    over `batch_axis` on a 2-D mesh, where the halos ride `axis` within
    each batch slice; `spatial_block` cuts B, the filter itself needs
    only `axis`, and takes batch_axis as the JAX package's does).  kind:
    'median' | 'mean' | 'gaussian'.  Each block needs two rows or
    more."""
    if kind not in _STENCILS:
        raise ValueError(f"unknown spatial filter kind {kind!r}: expected "
                         f"'median', 'mean' or 'gaussian'")
    stencil, border = _STENCILS[kind]
    group = mesh.get_group(axis)

    def fn(block: torch.Tensor) -> torch.Tensor:
        above, below = exchange_halo(block, group, border)
        return stencil(torch.cat([above, block, below], 1))[:, 1:-1]

    return fn


def spatial_block(mesh, images, axis: str = 'data',
                  batch_axis: str | None = None):
    """This rank's block of a global batch: rows of H over `axis`, and
    of B over `batch_axis` when given."""
    if batch_axis is not None:
        images = M.shard_batch(mesh, images, batch_axis)
    return images[:, M.batch_rows(mesh, images.shape[1], axis)]


def gather_spatial(mesh, block: torch.Tensor, axis: str = 'data',
                   batch_axis: str | None = None) -> torch.Tensor:
    """The inverse of spatial_block: every rank's block joined into the
    global batch (on every rank)."""
    rows = M.all_gather_rows(block.transpose(0, 1).contiguous(),
                             mesh.get_group(axis)).transpose(0, 1)
    if batch_axis is None:
        return rows.contiguous()
    return M.all_gather_rows(rows.contiguous(), mesh.get_group(batch_axis))
