# Frozen copy of tpudenoise_torch/noise/kmeans.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""The quant noise's k-means palette (counterpart of
`tpudenoise/noise/kmeans.py`: `kmeans_fit_traced_k`, `kmeans` with a
static k, and `quantize_colors`).

k-means++ init (one Gumbel-max draw per centre), 15 mini-batch steps over
cycling 1024-point slices with sklearn's cumulative-count update, then 3
full-batch Lloyd steps, for a cluster count `kk` of at most K_PAD.

The random draws depend only on the key, so `fit_draws` takes them on the
host from the threefry port (the fit subsample, the first centre and the
nine gumbel fields); the fit itself runs in torch on the points' device.
Distances are written out term by term; the centre sums over a slice are
a float64 matrix product rounded to float32, which is deterministic on
the card (no atomics) and does not depend on the TF32 switch.  XLA sums
in another order, so a centre can differ from the reference's by a few
ulps, and a label can flip on a near-tie.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.noise import prng
from portbench.reference.noise.color import bgr_u8_to_lab_u8, lab_u8_to_bgr_u8

K_PAD = 10      # max cluster count (quant_var10)
FIT_SET = 8192  # fit subsample size for larger images
_ITERS = 15
_LLOYD = 3


def fit_draws(key, n: int, k: int = K_PAD):
    """Host draws of a fit of k centres and of its fit subsample for an
    image of n pixels: (fit_idx (S,) int32 or None, first (int), gumbel
    (k - 1, S) float32).  The draws for k centres are the first ones of
    the draws for more."""
    if n > FIT_SET:
        key, sub = prng.split(key)
        fit_idx = prng.randint(sub, (FIT_SET,), 0, n)
        s = FIT_SET
    else:
        fit_idx, s = None, n
    key, sub = prng.split(key)
    first = int(prng.randint(sub, (), 0, s))
    gumbel = np.empty((k - 1, s), np.float32)
    for i in range(k - 1):
        key, sub = prng.split(key)
        gumbel[i] = prng.gumbel(sub, (s,))
    return fit_idx, first, gumbel


def _sq_dist(points: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = points - c
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def _assign(points, x2, centers, active):
    """argmin_k of x2 - 2 x.c + |c|^2 over the active centres."""
    p2 = 2.0 * points
    dot = ((p2[:, None, 0] * centers[None, :, 0]
            + p2[:, None, 1] * centers[None, :, 1])
           + p2[:, None, 2] * centers[None, :, 2])
    c2 = _sq_dist(centers, torch.zeros_like(centers[0]))
    d = (x2 - dot) + c2[None, :]
    d = torch.where(active[None, :], d, torch.full_like(d, float('inf')))
    return torch.argmin(d, dim=1)


def _counts_sums(labels, points):
    onehot = torch.nn.functional.one_hot(labels, K_PAD).to(torch.float64)
    sums = (onehot.T @ points.to(torch.float64)).to(torch.float32)
    return onehot.sum(0).to(torch.float32), sums


def kmeans_fit_traced_k(points: torch.Tensor, kk: int, first: int,
                        gumbel: torch.Tensor):
    """points (S, 3) float32; kk in [1, K_PAD]; first and gumbel
    (>= kk - 1, S) from `fit_draws`.  Returns (centers (K_PAD, 3),
    active (K_PAD,) bool); inactive centres keep their init value (the
    reference's init steps past kk change nothing, so they are skipped)."""
    n = points.shape[0]
    dev = points.device
    active = torch.arange(K_PAD, device=dev) < kk
    centers = torch.zeros((K_PAD, 3), dtype=torch.float32, device=dev)
    centers[0] = points[first]
    d2 = _sq_dist(points, points[first])
    for i in range(1, kk):
        logits = torch.log(torch.clamp(d2, min=float(np.float32(1e-12))))
        c = points[torch.argmax(logits + gumbel[i - 1])]
        centers[i] = c
        d2 = torch.minimum(d2, _sq_dist(points, c))

    x2 = _sq_dist(points, torch.zeros_like(points[0]))[:, None]
    mb = min(1024, n)
    cum = torch.zeros(K_PAD, dtype=torch.float32, device=dev)
    for i in range(_ITERS):
        start = min((i * mb) % n, n - mb)   # dynamic_slice clamps
        pts = points[start:start + mb]
        counts, sums = _counts_sums(
            _assign(pts, x2[start:start + mb], centers, active), pts)
        cum = cum + counts
        centers = centers + ((sums - counts[:, None] * centers)
                             / torch.clamp(cum[:, None], min=1.0))

    for _ in range(_LLOYD):
        counts, sums = _counts_sums(_assign(points, x2, centers, active),
                                    points)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        new = torch.where(counts[:, None] > 0, new, centers)
        centers = torch.where(active[:, None], new, centers)
    return centers, active


def kmeans(key, points: torch.Tensor, k: int):
    """The reference's static-k `kmeans` (iters 15, fit subsample 8192):
    points (N, 3) float32 -> (centers (k, 3), labels (N,)).  The fit is
    `kmeans_fit_traced_k` with kk = k (the reference's two fits share
    their stream), then every point goes to its nearest centre."""
    n = points.shape[0]
    fit_idx, first, gumbel = fit_draws(key, n, k)
    fit = points
    if fit_idx is not None:
        fit = points[torch.from_numpy(fit_idx.astype(np.int64)).to(
            points.device)]
    centers, _ = kmeans_fit_traced_k(fit, k, first,
                                     torch.from_numpy(gumbel).to(
                                         points.device))
    centers = centers[:k]
    x2 = _sq_dist(points, torch.zeros_like(points[0]))[:, None]
    active = torch.ones(k, dtype=torch.bool, device=points.device)
    return centers, _assign(points, x2, centers, active)


def quantize_colors(keys, img_u8: torch.Tensor, k: int) -> torch.Tensor:
    """The quant noise over (B, H, W, 3) u8-domain images, one key each:
    BGR -> u8 LAB, a k-means palette of the LAB pixels, centres truncated
    to u8, every pixel mapped to its centre's BGR."""
    out = torch.empty_like(img_u8, dtype=torch.float32)
    for i, im in enumerate(img_u8):
        pts = bgr_u8_to_lab_u8(im.reshape(-1, 3).to(torch.float32))
        centers, labels = kmeans(keys[i], pts, k)
        bgr = lab_u8_to_bgr_u8(torch.trunc(torch.clamp(centers, 0.0, 255.0)))
        out[i] = bgr[labels].reshape(im.shape)
    return out
