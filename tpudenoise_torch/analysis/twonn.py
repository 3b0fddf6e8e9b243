"""TwoNN intrinsic dimension (Facco et al. 2017) and the backbone probes
of the ID study (counterpart of `tpudenoise/analysis/twonn.py`).

For each point the two nearest neighbours r1 < r2 give mu = r2 / r1; the
empirical CDF F of mu satisfies -log(1 - F(mu)) = d * log(mu), so the ID
d is the through-origin slope over the first `fraction` of the sorted
points.  `compute_id` bootstraps `nres` subsets of 90% of the points,
drawn with numpy's `RandomState(seed)` as the reference draws them, so
both take the same subsets.  The distance matrix runs on the features'
device in float32 (TF32 off: `pairwise_dist` turns it off, as the eval
harness does).

`make_probe_fn` collects the activations at the named probe points of
PROBES (the pre-BN conv3 output of the named resnet units, the pre-ReLU
conv output of the vgg16 layers) and the head's stride-16 map, each
pooled to a grid of cells over each image's valid region.  The port's
convs read their weights through `models.rpn.conv`, so forward hooks on
the conv modules would not fire: the backbone heads take a `record`
callable and hand it each probe's output by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32_MAX = float(np.finfo(np.float32).max)


def pairwise_dist(x) -> torch.Tensor:
    """(N, D) -> (N, N) float32 euclidean distances by the x.xT
    expansion, the diagonal exactly 0."""
    from tpudenoise_torch.eval.harness import set_matmul_precision
    set_matmul_precision()
    x = torch.as_tensor(x).to(torch.float32)
    sq = (x * x).sum(1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    d2 = d2 * (1.0 - torch.eye(x.shape[0], dtype=x.dtype, device=x.device))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def estimate_from_dist(dist: torch.Tensor, fraction: float = 0.9):
    """The ID from a square distance matrix: (d, n_good).  Degenerate
    points (r1 == 0 or r1 == r2) are masked, not removed; the slope runs
    over the first floor(n_good * fraction) sorted mu, at most n_good - 2
    of them."""
    n = dist.shape[0]
    d = dist + torch.eye(n, dtype=dist.dtype, device=dist.device) * _F32_MAX
    pair = torch.topk(d, 2, dim=1, largest=False).values    # ascending
    r1, r2 = pair[:, 0], pair[:, 1]
    good = (r1 > 0) & (r1 != r2)
    n_good = good.sum()
    mu = torch.where(good, r2 / torch.clamp(r1, min=1e-30), _F32_MAX)
    mu = torch.sort(mu).values                              # good first
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=dist.device)
    femp = idx / torch.clamp(n_good, min=1).to(torch.float32)
    x = torch.log(mu)
    y = -torch.log(torch.clamp(1.0 - femp, min=1e-12))
    npoints = torch.floor(n_good.to(torch.float32) * fraction).to(
        torch.int64)
    keep = torch.arange(n, device=dist.device) < torch.minimum(
        npoints, n_good - 2)
    x = torch.where(keep, x, 0.0)
    y = torch.where(keep, y, 0.0)
    slope = (x * y).sum() / torch.clamp((x * x).sum(), min=1e-12)
    return slope, n_good


def compute_id(activations, nres: int = 20, fraction: float = 0.9,
               seed: int = 0):
    """Bootstrap mean and std of the ID over `nres` subsets of 90% of the
    points.  activations: (N, ...) numpy array or tensor, flattened to
    (N, D)."""
    r = torch.as_tensor(activations)
    r = r.reshape(r.shape[0], -1)
    n = int(np.round(r.shape[0] * 0.9))
    dist = pairwise_dist(r)
    rng = np.random.RandomState(seed)
    ids = []
    for _ in range(nres):
        perm = torch.from_numpy(rng.permutation(r.shape[0])[:n]).to(
            dist.device)
        d, _ = estimate_from_dist(dist[perm][:, perm], fraction=fraction)
        ids.append(float(d))
    return float(np.mean(ids)), float(np.std(ids))


# the probe points of the reference's ID study, per backbone: the conv3
# output of named bottleneck units for the resnets, named conv layers for
# vgg16, and for mobile the pointwise conv's output (before pw_bn) of
# every other depthwise layer (`tpudenoise/analysis/twonn.py:121-149`)
PROBES = {
    'res101': ['block1/unit_1/conv3', 'block2/unit_1/conv3',
               'block2/unit_4/conv3', 'block3/unit_8/conv3',
               'block3/unit_11/conv3', 'block3/unit_14/conv3',
               'block3/unit_17/conv3', 'block3/unit_20/conv3',
               'block3/unit_23/conv3'],
    'res50': ['block1/unit_1/conv3', 'block1/unit_3/conv3',
              'block2/unit_1/conv3', 'block2/unit_2/conv3',
              'block2/unit_3/conv3', 'block2/unit_4/conv3',
              'block3/unit_3/conv3', 'block3/unit_4/conv3'],
    'res152': ['block1/unit_1/conv3', 'block2/unit_1/conv3',
               'block2/unit_4/conv3', 'block3/unit_8/conv3',
               'block3/unit_11/conv3', 'block3/unit_14/conv3',
               'block3/unit_17/conv3', 'block3/unit_20/conv3',
               'block3/unit_23/conv3'],
    'vgg16': ['conv1_1', 'conv1_2', 'conv2_2', 'conv3_3', 'conv4_3',
              'conv5_3'],
    'mobile': ['layer_1/pointwise', 'layer_3/pointwise',
               'layer_5/pointwise', 'layer_7/pointwise',
               'layer_9/pointwise', 'layer_11/pointwise'],
}


def _grid_pool(feat: torch.Tensor, grid: int) -> torch.Tensor:
    """(H, W, C) -> (grid*grid*C,) adaptive average pooling over the
    whole map, each cell's mean in the feature's dtype, then float32.  A
    map smaller than the grid widens an empty cell to one row or
    column."""
    h, w, _ = feat.shape
    hb = np.linspace(0, h, grid + 1).astype(int)
    wb = np.linspace(0, w, grid + 1).astype(int)

    def cell(i, j):
        y0 = min(hb[i], h - 1)
        y1 = max(hb[i + 1], y0 + 1)
        x0 = min(wb[j], w - 1)
        x1 = max(wb[j + 1], x0 + 1)
        return feat[y0:y1, x0:x1].mean(dim=(0, 1))

    return torch.cat([cell(i, j) for i in range(grid)
                      for j in range(grid)]).to(torch.float32)


def _grid_pool_dyn(feat: torch.Tensor, hw, grid: int) -> torch.Tensor:
    """_grid_pool over each image's valid top-left region, batched:
    feat (B, H, W, C), hw (B, 2) valid extents (host ints).  The cells
    are float32 sums by two 0/1 weight matmuls (bin membership of rows,
    then of columns) over counts, the reference's dynamic form."""
    b, h_full, w_full, _ = feat.shape
    dev = feat.device
    hw = torch.as_tensor(np.asarray(hw, np.int64).reshape(b, 2), device=dev)
    ar = torch.arange(grid + 1, dtype=torch.float32, device=dev)

    def bins(extent):
        edges = torch.floor(ar[None] * extent[:, None].to(torch.float32)
                            / grid).to(torch.int64)
        lo = torch.minimum(edges[:, :-1], extent[:, None] - 1)
        hi = torch.maximum(edges[:, 1:], lo + 1)
        return lo, hi

    (y0, y1), (x0, x1) = bins(hw[:, 0]), bins(hw[:, 1])
    rows = torch.arange(h_full, device=dev)
    cols = torch.arange(w_full, device=dev)
    rw = ((rows >= y0[..., None]) & (rows < y1[..., None])).to(
        torch.float32)                                      # (B, g, H)
    cw = ((cols >= x0[..., None]) & (cols < x1[..., None])).to(
        torch.float32)                                      # (B, g, W)
    tmp = torch.einsum('bgh,bhwc->bgwc', rw, feat.to(torch.float32))
    sums = torch.einsum('bjw,bgwc->bgjc', cw, tmp)          # (B, g, g, C)
    counts = ((y1 - y0)[:, :, None] * (x1 - x0)[:, None, :]).to(
        torch.float32)[..., None]
    return (sums / counts).reshape(b, -1)


def _infer_stride(n_in: int, n_out: int) -> int:
    """The cumulative SAME stride from static extents, n_out = ceil(n_in
    / s), rounded in log space (every backbone stride is a power of 2)."""
    return 1 << round(math.log2(n_in / n_out))


def make_probe_fn(model, grid: int = 4):
    """fn(params, images (B, H, W, 3) preprocessed, hw=None) -> {probe:
    (B, grid*grid*C)} for every probe of PROBES[model.backbone] and
    'head' (the stride-16 map), in one forward of the head with
    `params` (a state dict of the whole detector).  hw: (B, 2) valid
    (h, w) of bucket-padded images (host ints); each probe then pools
    over ceil(hw / stride) of its own map."""
    probes = PROBES.get(model.backbone, [])
    wanted = set(probes)

    @torch.no_grad()
    def run(params, images: torch.Tensor, hw=None) -> dict:
        head_params = {k[len('head.'):]: v for k, v in params.items()
                       if k.startswith('head.')}
        inter = {}

        def record(name, x):
            if name in wanted:
                inter[name] = x

        feat = torch.func.functional_call(
            model.head, head_params, (images.permute(0, 3, 1, 2),),
            {'record': record})
        h_in, w_in = images.shape[1], images.shape[2]

        def pool(arr):                      # NCHW -> (B, g*g*C)
            arr = arr.permute(0, 2, 3, 1)
            if hw is None:
                return torch.stack([_grid_pool(f, grid) for f in arr])
            sy = _infer_stride(h_in, arr.shape[1])
            sx = _infer_stride(w_in, arr.shape[2])
            e = np.asarray(hw, np.int64).reshape(-1, 2)
            return _grid_pool_dyn(arr, np.stack([-(-e[:, 0] // sy),
                                                 -(-e[:, 1] // sx)], 1),
                                  grid)

        out = {p: pool(inter[p]) for p in probes}
        out['head'] = pool(feat)
        return out

    return run


def per_layer_id(feats: dict, nres: int = 10, seed: int = 0) -> dict:
    """{probe: (N, D) stacked features} -> {probe: (mean_id, std_id)},
    in the order of feats (the probes shallow to deep, then 'head')."""
    return {p: compute_id(v, nres=nres, seed=seed)
            for p, v in feats.items()}


def backbone_intrinsic_dim(model, params, images, probes=None,
                           nres: int = 5, grid: int = 4):
    """The backbone over a batch (B, H, W, 3), then the TwoNN ID at every
    probe point and 'head': {probe: (mean, err)}."""
    fn = make_probe_fn(model, grid=grid)
    feats = fn(params, torch.as_tensor(images))
    if probes is not None:
        feats = {p: v for p, v in feats.items() if p in probes}
    return per_layer_id(feats, nres=nres)
