# Frozen copy of tpudenoise_torch/noise/pipeline.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""Noise -> denoise pipelines for a parsed plan (counterpart of
`tpudenoise/noise/pipeline.py`), cut to the routes that the benchmark's
traffic mixes reach, each as the reference's `use_pallas=True` route:

* `sap` + median and `gaussian` + gaussian blur, each with an optional
  standalone post-pass of the same filter (`pipeline.py:475-568`);
* mixed noise with no denoise (`_fused_mix_pipeline`,
  `pipeline.py:323-390`): the mix prologue, then the fused mix kernel's
  math;
* a single kind whose only denoise stages are bilateral: the generator,
  then each bilateral stage as one pass over the batch
  (`_pallas_bilateral_pipeline`, `pipeline.py:393-436`);
* every other single-kind plan of the original, gaussian (its level
  drawn per image from the three random levels where the string asks),
  speckle, periodic or quant kind with no denoise (`pipeline.py:570-629`):
  the threefry generators (`generators.py`, `kmeans.quantize_colors`).

Any other plan raises NotImplementedError: no traffic mix runs it yet,
and a mix that does brings its copy first.  Seeds and key algebra come
from the numpy threefry port (`prng`), and the generators' fields from
its device draws, so the draws equal the reference's.

`make_pipeline(...).keyed(keys, images)` takes one (2,) uint32 key per
image ((B, 2)) and (B, H, W, 3) uint8 or float32 u8-domain images on any
device, and returns float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.noise import generators as G
from portbench.reference.noise import prng
from portbench.reference.noise.bilateral import bilateral_batched
from portbench.reference.noise.fused_kernels import (fused_gaussian_blur,
                                                     fused_sap_median_batched)
from portbench.reference.noise.kmeans import quantize_colors
from portbench.reference.noise.mix_kernels import fused_mix_noise
from portbench.reference.noise.mix_prologue import mix_prologue, plan_tables
from portbench.reference.noise.spec import (GAUSSIAN_RANDOM_LEVELS, Denoise,
                                            Kind, NoiseSpec, parse)
from portbench.reference.noise.transfer import to_device

_SEED_MAX = 2**31 - 1


def _to_u8(images: torch.Tensor) -> torch.Tensor:
    """Round half-to-even, clip, cast: the fused kernels' u8 input."""
    if images.dtype == torch.uint8:
        return images
    return torch.clamp(torch.round(images), 0, 255).to(torch.uint8)


def _keys(keys, images: torch.Tensor) -> np.ndarray:
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    if keys.shape[0] != images.shape[0]:
        raise ValueError('one key per image')
    return keys


class _Pipeline:
    """A fused sap or gaussian route: per image one seed (and level),
    drawn as a B=1 run would."""

    def __init__(self, backend: str, draw, run):
        self.backend = backend
        self._draw = draw      # (B, 2) keys -> kernel arguments
        self._run = run        # (u8 images, *args) -> images

    def keyed(self, keys, images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        args = [to_device(a, dev) if a is not None else None
                for a in self._draw(_keys(keys, images))]
        return self._run(_to_u8(images), *args).to(torch.float32)


def _sap_pipeline(amount: float, double: bool) -> _Pipeline:
    def draw(keys):
        return [prng.randint(keys, (1,), 0, _SEED_MAX)[:, 0]]

    def run(images, seeds):
        return fused_sap_median_batched(images, seeds, amount, double)

    return _Pipeline('cuda:sap_median', draw, run)


def _gauss_pipeline(levels, double: bool) -> _Pipeline:
    # sqrt in f32, as jnp.sqrt(jnp.asarray(levels, f32))
    lvl_sigma = np.sqrt(np.asarray(levels, np.float32))

    def draw(keys):
        pairs = prng.split(keys)
        seeds = prng.randint(pairs[:, 0], (1,), 0, _SEED_MAX)[:, 0]
        idx = prng.randint(pairs[:, 1], (1,), 0, len(levels))[:, 0]
        return [seeds, lvl_sigma[idx] if len(levels) > 1 else None]

    def run(images, seeds, sigmas):
        return fused_gaussian_blur(images, seeds, levels[0], double,
                                   sigmas=sigmas)

    return _Pipeline('cuda:gaussian_blur', draw, run)


class _PerImagePipeline:
    """A route whose draws take one key per image: `keyed` takes
    split(k, 1)[0] of each image's key (as a B=1 call would)."""

    def __init__(self, backend: str, apply):
        self.backend = backend
        self._apply = apply    # ((B, 2) uint32 keys, images) -> images

    def keyed(self, keys, images: torch.Tensor) -> torch.Tensor:
        return self._apply(prng.split(_keys(keys, images), 1)[:, 0], images)


def apply_spec(spec: NoiseSpec, keys, img: torch.Tensor) -> torch.Tensor:
    """One (kind, level) with no denoise over (B, H, W, 3) float32
    u8-domain images with one key each ((B, 2) uint32).  Returns
    u8-domain float32, or the [0, 1] floats of plain gaussian (a
    reference quirk)."""
    if spec.denoise != Denoise.NONE:
        raise NotImplementedError(f'no copy of {spec} in the reference')
    kind, lvl = spec.kind, spec.level
    if spec.is_random_level:
        if kind != Kind.GAUSSIAN:
            raise NotImplementedError(f'no copy of {spec} in the reference')
        kl, keys = np.moveaxis(prng.split(keys), -2, 0)
        idx = prng.randint(kl, (), 0, len(GAUSSIAN_RANDOM_LEVELS))
        lvl = torch.from_numpy(np.asarray(
            GAUSSIAN_RANDOM_LEVELS, np.float32)[idx]).to(img.device)
    if kind == Kind.ORIGINAL:
        return img
    if kind == Kind.PERIODIC:
        return G.periodic(img, lvl)
    if kind == Kind.QUANT:
        return quantize_colors(keys, img, int(lvl))
    if kind == Kind.GAUSSIAN:
        noisy = G.gaussian(keys, img, lvl)
        if spec.unit_float_output:
            return noisy
    elif kind == Kind.SPECKLE:
        noisy = G.speckle(keys, img, lvl)
    else:
        raise NotImplementedError(f'no copy of {kind} in the reference')
    return G.wrap_cast_u8(255.0 * noisy)


def _mix_pipeline(specs) -> _PerImagePipeline:
    """The mix prologue, then the fused mix kernel's math."""
    kinds, eb, el = plan_tables(specs)

    def apply(keys, images):
        args = mix_prologue(keys, images, kinds, eb, el)
        return fused_mix_noise(_to_u8(images), *args, kinds)

    return _PerImagePipeline('cuda:fused_mix', apply)


def _bilateral_pipeline(spec: NoiseSpec, n_stages: int) -> _PerImagePipeline:
    """The generator without its bilateral, then each bilateral stage (the
    spec's and the post-pass) as one pass over the batch."""
    stripped = dataclasses.replace(spec, denoise=Denoise.NONE)

    def apply(keys, images):
        out = apply_spec(stripped, keys, images.to(torch.float32))
        for _ in range(n_stages):
            out = bilateral_batched(out)
        return out

    return _PerImagePipeline(f'cuda:bilateral_x{n_stages}', apply)


def make_pipeline(noise: str, mode: str = 'TEST'):
    """The pipeline of a noise string, as the port's `make_pipeline`
    builds it by default."""
    plan = parse(noise, mode=mode)
    specs, post = plan.specs, plan.post_denoise
    if len(specs) > 1:
        if post != Denoise.NONE or any(
                s.denoise != Denoise.NONE or s.is_random_level
                for s in specs):
            raise NotImplementedError(f'no copy of {noise!r}')
        return _mix_pipeline(specs)
    s = specs[0]
    if (s.kind == Kind.SAP and s.denoise == Denoise.MEDIAN
            and post in (Denoise.MEDIAN, Denoise.NONE)):
        return _sap_pipeline(s.level, post == Denoise.MEDIAN)
    if (s.kind == Kind.GAUSSIAN and s.denoise == Denoise.GAUS_BLUR
            and post in (Denoise.GAUS_BLUR, Denoise.NONE)):
        levels = (GAUSSIAN_RANDOM_LEVELS if s.is_random_level
                  else [s.level])
        return _gauss_pipeline(levels, post == Denoise.GAUS_BLUR)
    stages = (s.denoise == Denoise.BILATERAL) + (post == Denoise.BILATERAL)
    if (stages and s.denoise in (Denoise.NONE, Denoise.BILATERAL)
            and post in (Denoise.NONE, Denoise.BILATERAL)):
        return _bilateral_pipeline(s, stages)
    if post != Denoise.NONE:
        raise NotImplementedError(f'no copy of {noise!r}')
    return _PerImagePipeline(
        'cuda:generic',
        lambda keys, images: apply_spec(s, keys, images.to(torch.float32)))
