# Frozen copy of tpudenoise_torch/noise/mix_prologue.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""Per-image scalars of the fused mix kernels (counterpart of
`tpudenoise/noise/pallas_mix.py` `plan_tables` and `mix_prologue`).

For each image: the entry draw (which kind and level of the plan's mix
table it gets), the two hash seed words, and the image-dependent scalars
of the kinds that need them, computed only for the images that drew that
kind:

* poisson: `vals` = 2^ceil(log2(distinct u8 values)) (1 elsewhere);
* quant: the k-means palette, (K_PAD * 6,) per image: LAB of each centre
  (1e9 for inactive ones) and the BGR of the truncated centre (0
  elsewhere);
* bloom: the (48, 8) compositing steps (0 elsewhere).

The key algebra runs in numpy on the host (`core.prng`, bit-equal to
jax); the unique counts and the k-means fits run on the images' device.
The reference fits every image under a static budget with a fallback
because TPU shapes are static; here the host knows which images drew
quant and fits those alone, which gives the same palettes.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.noise import prng
from portbench.reference.noise import kmeans
from portbench.reference.noise.generators import (N_STEPS, bloom_params,
                                               u8_unique_count)
from portbench.reference.noise.spec import Kind
from portbench.reference.noise.color import bgr_u8_to_lab_u8, lab_u8_to_bgr_u8

K_PAD = kmeans.K_PAD


def plan_tables(specs):
    """(kinds present, sorted by enum value; per-entry branch position
    (E,) int32; per-entry level (E,) float32)."""
    kinds = tuple(sorted({int(s.kind) for s in specs}))
    pos_of = {k: i for i, k in enumerate(kinds)}
    eb = np.asarray([pos_of[int(s.kind)] for s in specs], np.int32)
    el = np.asarray([float(s.level) for s in specs], np.float32)
    return kinds, eb, el


def entry_draws(keys, eb, el):
    """Host part: per-image (branch position, level, seeds (2,) int32,
    ka key) from per-image keys, as the reference's split -> randint."""
    kc, ka = np.moveaxis(prng.split(np.asarray(keys, np.uint32)
                                    .reshape(-1, 2)), 1, 0)
    idx = prng.randint(kc, (), 0, len(eb))
    seeds = np.ascontiguousarray(ka[:, [0, -1]]).view(np.int32)
    return eb[idx], el[idx], seeds, ka


def quant_palette(ka, image: torch.Tensor, kk: int) -> torch.Tensor:
    """(K_PAD * 6,) palette of one image (H, W, 3): LAB centres fitted on
    the u8 LAB of the (subsampled) pixels, then the BGR of the truncated
    centres."""
    flat = image.reshape(-1, 3).to(torch.float32)
    fit_idx, first, gumbel = kmeans.fit_draws(ka, flat.shape[0], kk)
    rows = gumbel if fit_idx is None else np.concatenate(
        [fit_idx.astype(np.float32)[None], gumbel])   # indices < 2^24
    rows = torch.from_numpy(rows).to(image.device)     # one transfer
    if fit_idx is not None:
        flat = flat[rows[0].to(torch.int64)]
        rows = rows[1:]
    centers, active = kmeans.kmeans_fit_traced_k(
        bgr_u8_to_lab_u8(flat), kk, first, rows)
    bgr = lab_u8_to_bgr_u8(torch.trunc(torch.clamp(centers, 0.0, 255.0)))
    lab = torch.where(active[:, None], centers,
                      torch.full_like(centers, 1e9))
    return torch.cat([lab, bgr], 1).reshape(-1)


def mix_prologue(keys, images: torch.Tensor, kinds, eb, el):
    """keys: (B, 2) uint32 per-image keys (already split as the pipeline
    splits them); images (B, H, W, 3) u8 or u8-domain float32.  Returns
    (branch (B,) int32, level (B,) f32, seeds (B, 2) int32, vals (B,)
    f32, centers (B, K_PAD*6) f32, bloom (B, 48, 8) f32) on the images'
    device."""
    pos, level, seeds, kas = entry_draws(keys, eb, el)
    b, h, w, _ = images.shape
    dev = images.device

    def drew(kind):
        if int(kind) not in kinds:
            return []
        return np.nonzero(pos == kinds.index(int(kind)))[0].tolist()

    vals = torch.ones(b, dtype=torch.float32, device=dev)
    for i in drew(Kind.POISSON):
        uc = u8_unique_count(images[i]).to(torch.float64)
        vals[i] = torch.exp2(torch.ceil(torch.log2(uc))).to(torch.float32)

    centers = torch.zeros((b, K_PAD * 6), dtype=torch.float32, device=dev)
    for i in drew(Kind.QUANT):
        centers[i] = quant_palette(kas[i], images[i], int(level[i]))

    bloom = np.zeros((b, N_STEPS, 8), np.float32)
    ids = drew(Kind.BLOOM)
    if ids:
        bloom[ids] = bloom_params(kas[ids], h, w)

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    return (dev_t(pos), dev_t(level), dev_t(seeds), vals, centers,
            dev_t(bloom))

