"""Noise -> denoise pipelines for a parsed plan (counterpart of
`tpudenoise/noise/pipeline.py`).

Ported routes (the reference's `use_pallas=True` routes):
* `sap` + median and `gaussian` + gaussian blur, each with an optional
  standalone post-pass of the same filter (`pipeline.py:475-568`);
* mixed noise (`_fused_mix_pipeline`, `pipeline.py:323-390`): the mix
  prologue, then the fused mix kernel, or the fused mix + bilateral
  kernel when the plan's post-pass is bilateral;
* single-kind `bloom` on the generic route (`pipeline.py:110-117`).
Seeds and draws come from the numpy threefry port (`core.prng`), so they
equal the reference's.  Every other plan raises NotImplementedError;
nothing falls back to another route.

The returned callable `fn(key, images)` takes a (2,) uint32 key and
(B, H, W, 3) uint8 or float32 u8-domain images on any device and returns
float32; `fn.keyed(keys, images)` takes one key per image ((B, 2)) and
`fn.backend` names the route.  `fn.masked(keys, images, hw)` is `keyed`
for the sap and gaussian routes (stencils with no dependence on the
valid extent); the mix and bloom routes do not port it yet.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.noise.bloom import bloom_batched
from tpudenoise_torch.noise.fused_kernels import (fused_gaussian_blur,
                                                  fused_sap_median_batched)
from tpudenoise_torch.noise.generators import bloom_params
from tpudenoise_torch.noise.mix_kernels import (fused_mix_bilateral,
                                                fused_mix_noise)
from tpudenoise_torch.noise.mix_prologue import mix_prologue, plan_tables
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
        return [prng.randint(keys, (1,), 0, _SEED_MAX)[:, 0]]

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
            pairs = prng.split(keys)
            seeds = prng.randint(pairs[:, 0], (1,), 0, _SEED_MAX)[:, 0]
            idx = prng.randint(pairs[:, 1], (1,), 0, len(levels))[:, 0]
        return [seeds, lvl_sigma[idx] if len(levels) > 1 else None]

    def run(images, seeds, sigmas):
        return fused_gaussian_blur(images, seeds, levels[0], double,
                                   sigmas=sigmas)

    return _Pipeline('cuda:gaussian_blur', draw, run)


class _PerImagePipeline:
    """A route whose draws take one key per image: `__call__` splits the
    key over the batch, `keyed` takes split(k, 1)[0] of each image's key
    (as a B=1 call would)."""

    def __init__(self, backend: str, apply):
        self.backend = backend
        self._apply = apply    # ((B, 2) uint32 keys, images) -> images

    def __call__(self, key, images: torch.Tensor) -> torch.Tensor:
        return self._apply(prng.split(key, images.shape[0]), images)

    def keyed(self, keys, images: torch.Tensor) -> torch.Tensor:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if keys.shape[0] != images.shape[0]:
            raise ValueError('one key per image')
        return self._apply(prng.split(keys, 1)[:, 0], images)

    def masked(self, keys, images: torch.Tensor, hw) -> torch.Tensor:
        raise NotImplementedError(
            f'{self.backend}: the bucketed (masked) noise path runs the '
            f'XLA generators in the reference and is not ported yet '
            f'(ROADMAP Queue 1 items 6 and 9)')


def _mix_pipeline(plan: NoisePlan) -> _PerImagePipeline:
    kinds, eb, el = plan_tables(plan.specs)
    bilateral = plan.post_denoise == Denoise.BILATERAL

    def apply(keys, images):
        args = mix_prologue(keys, images, kinds, eb, el)
        run = fused_mix_bilateral if bilateral else fused_mix_noise
        return run(_to_u8(images), *args, kinds)

    return _PerImagePipeline(
        'cuda:fused_mix' + ('+bilateral' if bilateral else ''), apply)


def _bloom_pipeline() -> _PerImagePipeline:
    def apply(keys, images):
        h, w = images.shape[1:3]
        params = bloom_params(keys, h, w)
        return bloom_batched(images, torch.from_numpy(params).to(
            images.device))

    return _PerImagePipeline('cuda:bloom', apply)


_POST_ITEM = {Denoise.WAVELET: 'Queue 1 item 10',
              Denoise.CURVELET: 'Queue 1 item 13'}


def make_pipeline(plan: NoisePlan | str, mode: str = 'TEST',
                  strict_ref: bool = False):
    """Build the pipeline for a parsed plan (or raw noise string)."""
    if isinstance(plan, str):
        plan = parse(plan, mode=mode, strict_ref=strict_ref)
    specs = plan.specs
    if len(specs) > 1 and all(s.denoise == Denoise.NONE
                              and not s.is_random_level for s in specs):
        if plan.post_denoise in (Denoise.NONE, Denoise.BILATERAL):
            return _mix_pipeline(plan)
        raise NotImplementedError(
            f'noise plan {plan.raw!r}: the {plan.post_denoise.name.lower()} '
            f'post-pass after the fused mix is not ported yet (ROADMAP '
            f'{_POST_ITEM.get(plan.post_denoise, "Queue 1 item 3")})')
    if len(specs) == 1:
        s = specs[0]
        if (s.kind == Kind.BLOOM and s.denoise == Denoise.NONE
                and plan.post_denoise == Denoise.NONE):
            return _bloom_pipeline()
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
        f'noise plan {plan.raw!r}: the ported routes are fused '
        f'sap+median, gaussian+blur, the fused mixes (no post-pass or '
        f'bilateral) and bloom; the threefry generators, the standalone '
        f'bilateral and the stencils are ROADMAP Queue 1 items 3, 8 and 9 '
        f'and Queue 2 item 5')
