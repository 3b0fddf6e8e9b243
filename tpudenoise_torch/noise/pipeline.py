"""Noise -> denoise pipelines for a parsed plan (counterpart of
`tpudenoise/noise/pipeline.py`).

Only the two single-kind fused routes are ported: `sap` + median and
`gaussian` + gaussian blur, each with an optional standalone post-pass of
the same filter (`pipeline.py:475-568`).  Their per-image seeds come from
the numpy threefry port (`core.prng`), so they equal the reference's.
Every other plan raises NotImplementedError; nothing falls back to
another route.

The returned callable `fn(key, images)` takes a (2,) uint32 key and
(B, H, W, 3) uint8 or float32 u8-domain images on any device and returns
float32; `fn.keyed(keys, images)` takes one key per image ((B, 2)),
`fn.masked(keys, images, hw)` is `keyed` (both kernels are stencils with
no dependence on the valid extent) and `fn.backend` names the route.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.noise.fused_kernels import (fused_gaussian_blur,
                                                  fused_sap_median_batched)
from tpudenoise_torch.noise.spec import (GAUSSIAN_RANDOM_LEVELS, Denoise,
                                         Kind, NoisePlan, parse)

_SEED_MAX = 2**31 - 1


def _to_u8(images: torch.Tensor) -> torch.Tensor:
    """Round half-to-even, clip, cast: the fused kernels' u8 input."""
    if images.dtype == torch.uint8:
        return images
    return torch.clamp(torch.round(images), 0, 255).to(torch.uint8)


class _Pipeline:
    def __init__(self, backend: str, draw, run):
        self.backend = backend
        self._draw = draw      # (keys, batched: bool) -> kernel arguments
        self._run = run        # (u8 images, *args) -> images

    def _apply(self, images, args):
        dev = images.device
        args = [torch.as_tensor(a, device=dev) if a is not None else None
                for a in args]
        return self._run(_to_u8(images), *args).to(torch.float32)

    def __call__(self, key, images: torch.Tensor) -> torch.Tensor:
        return self._apply(images, self._draw([key], images.shape[0]))

    def keyed(self, keys, images: torch.Tensor) -> torch.Tensor:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if keys.shape[0] != images.shape[0]:
            raise ValueError('one key per image')
        return self._apply(images, self._draw(keys, None))

    def masked(self, keys, images: torch.Tensor, hw) -> torch.Tensor:
        return self.keyed(keys, images)


def _sap_pipeline(amount: float, double: bool) -> _Pipeline:
    def draw(keys, batch):
        if batch is not None:     # one key, (B,) seeds
            return [prng.randint(keys[0], (batch,), 0, _SEED_MAX)]
        # one seed per per-image key, drawn as a B=1 run would
        return [np.concatenate([prng.randint(k, (1,), 0, _SEED_MAX)
                                for k in keys])]

    def run(images, seeds):
        return fused_sap_median_batched(images, seeds, amount, double)

    return _Pipeline('cuda:sap_median', draw, run)


def _gauss_pipeline(levels, double: bool) -> _Pipeline:
    # sqrt in f32, as jnp.sqrt(jnp.asarray(levels, f32))
    lvl_sigma = np.sqrt(np.asarray(levels, np.float32))

    def draw(keys, batch):
        if batch is not None:
            k1, k2 = prng.split(keys[0])
            seeds = prng.randint(k1, (batch,), 0, _SEED_MAX)
            idx = prng.randint(k2, (batch,), 0, len(levels))
        else:
            pairs = [prng.split(k) for k in keys]
            seeds = np.concatenate([prng.randint(k1, (1,), 0, _SEED_MAX)
                                    for k1, _ in pairs])
            idx = np.concatenate([prng.randint(k2, (1,), 0, len(levels))
                                  for _, k2 in pairs])
        return [seeds, lvl_sigma[idx] if len(levels) > 1 else None]

    def run(images, seeds, sigmas):
        return fused_gaussian_blur(images, seeds, levels[0], double,
                                   sigmas=sigmas)

    return _Pipeline('cuda:gaussian_blur', draw, run)


def make_pipeline(plan: NoisePlan | str, mode: str = 'TEST',
                  strict_ref: bool = False) -> _Pipeline:
    """Build the pipeline for a parsed plan (or raw noise string)."""
    if isinstance(plan, str):
        plan = parse(plan, mode=mode, strict_ref=strict_ref)
    specs = plan.specs
    if len(specs) == 1:
        s = specs[0]
        if (s.kind == Kind.SAP and s.denoise == Denoise.MEDIAN
                and plan.post_denoise in (Denoise.MEDIAN, Denoise.NONE)):
            return _sap_pipeline(s.level,
                                 plan.post_denoise == Denoise.MEDIAN)
        if (s.kind == Kind.GAUSSIAN and s.denoise == Denoise.GAUS_BLUR
                and plan.post_denoise in (Denoise.GAUS_BLUR, Denoise.NONE)):
            levels = (GAUSSIAN_RANDOM_LEVELS if s.is_random_level
                      else [s.level])
            return _gauss_pipeline(levels,
                                   plan.post_denoise == Denoise.GAUS_BLUR)
    raise NotImplementedError(
        f'noise plan {plan.raw!r}: only the fused sap+median and '
        f'gaussian+blur routes are ported; the other single-kind plans, '
        f'bilateral and mixed noise are ROADMAP Queue 1 items 3, 8 and 9 '
        f'and Queue 2 items 4-7')
