"""Noise -> denoise pipelines for a parsed plan (counterpart of
`tpudenoise/noise/pipeline.py`).

`make_pipeline(..., use_kernels=...)` is the reference's `use_pallas`.
None or True (every caller's default) take the reference's
`use_pallas=True` routes, on any device:
* `sap` + median and `gaussian` + gaussian blur, each with an optional
  standalone post-pass of the same filter (`pipeline.py:475-568`);
* mixed noise (`_fused_mix_pipeline`, `pipeline.py:323-390`): the mix
  prologue, then the fused mix kernel, or the fused mix + bilateral
  kernel when the plan's post-pass is bilateral, or a 3x3 stencil
  post-pass after the fused mix kernel;
* every other single-kind plan (`pipeline.py:570-629`): the threefry
  generators (`generators.py`, `samplers.py`, `kmeans.quantize_colors`;
  bloom through the bloom kernel), then the per-spec denoise and the
  post-pass as 3x3 stencils or the wavelet denoiser; a plan whose only
  denoise stages are bilateral runs each as one pass of the bilateral
  kernel (`_pallas_bilateral_pipeline`, `pipeline.py:393-436`).
The wavelet (`denoise/wavelet.py`, f32 matmuls) runs batched over the
whole batch with per-image statistics, on the noisy floats for the kinds
of `_WAVELET_ON_FLOAT` and on the u8 image scaled to [0, 1] for the
rest, then `wrap_cast_u8(255 * w)` (`pipeline.py:53-58, 126-157`).
`use_kernels=False` is the reference's XLA route, its semantics
reference (`pipeline.py:459-461, 584-629`): every plan, the sap, gaussian,
bilateral-only and mix plans included, goes through the generic route,
backend 'xla' (or 'xla+fast_rng'): the threefry generators (a top-level
gaussian drawing its level per image), the 3x3 stencils or the wavelet,
a mix through the mix scan with fast_rng reaching every generator; its
bilateral stages run the bilateral kernel (within 1 level of the
reference's XLA chain on < 1e-3 of the pixels) and bloom the bloom
kernel (bit-equal to its XLA scan), and on a GPU the draws come from the
threefry kernel, or the hash kernel under fast_rng.
Seeds and key algebra come from the numpy threefry port (`core.prng`),
and the generators' fields from its device draws, so the draws equal the
reference's.  A mix table outside the fused kernels goes through the mix
scan (`_apply_specs_batched`, `pipeline.py:182-283`): per image, the
entry draw of `mix_prologue.entry_draws` (the fused routes' own draw, so
both pick the same kind for a key), then the drawn entry's template with
its level as float32 (`_group_specs`).  The curvelet post-pass
(`denoise/curvelet.py`, `torch.fft`) runs 4 images at a time, as the
reference's `lax.map` (`pipeline.py:305-316`).  Nothing falls back to
another route.

`fast_rng=True` (`--fast-rng`) draws every stochastic generator of the
generic and bilateral routes from the counter hash (the hash-stream
kernel; `generators.py`, `samplers.py`) and adds '+fast_rng' to their
backend, as the reference's `pipeline.py:435, 628`.  The sap, gaussian
and mix routes draw from their kernels' own coordinate hash and take no
notice of it, their bucketed forms included (`pipeline.py:323-390,
476-588`), as in the reference.

The returned callable `fn(key, images)` takes a (2,) uint32 key and
(B, H, W, 3) uint8 or float32 u8-domain images on any device and returns
float32; `fn.keyed(keys, images)` takes one key per image ((B, 2)) and
`fn.backend` names the route.  `fn.masked(keys, images, hw)` is the
bucketed form (the training batches of `train/solver.py`): images
edge-padded to a bucket with each one's valid (h, w) in hw, host ints.
The sap and gaussian routes' masked is `keyed` (noise and stencils with
no dependence on the valid extent); the generic and bilateral routes
pass hw to the generators whose raster depends on it (brownian,
periodic, quant, bloom; `pipeline.py:570-629, 423-430`) and to the
wavelet, whose statistics then count each image's valid region only;
their 3x3 stencils, bilateral passes and wavelet reconstruction run over
the whole canvas.  The fused mix routes' masked is the reference's
`run_masked` (`pipeline.py:376-384`): the mix scan with hw, then the
plan's post-pass over the canvas, a bilateral one through the bilateral
kernel (`bilateral_batched`), the wavelet with hw for its statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.denoise import stencils
from tpudenoise_torch.denoise.bilateral import bilateral_batched
from tpudenoise_torch.denoise.curvelet import curvelet_denoise_batched
from tpudenoise_torch.denoise.wavelet import denoise_wavelet_batched
from tpudenoise_torch.noise import generators as G
from tpudenoise_torch.noise.bloom import bloom_batched
from tpudenoise_torch.noise.fused_kernels import (fused_gaussian_blur,
                                                  fused_sap_median_batched)
from tpudenoise_torch.noise.generators import bloom_params
from tpudenoise_torch.noise.kmeans import quantize_colors
from tpudenoise_torch.noise.mix_kernels import (fused_mix_bilateral,
                                                fused_mix_noise)
from tpudenoise_torch.noise.mix_prologue import (entry_draws, mix_prologue,
                                                 plan_tables)
from tpudenoise_torch.noise.spec import (GAUSSIAN_RANDOM_LEVELS, Denoise,
                                         Kind, NoisePlan, NoiseSpec, parse)
from tpudenoise_torch.utils.transfer import to_device

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
        args = [to_device(a, dev) if a is not None else None for a in args]
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

    def share(self, key, images: torch.Tensor, start: int,
              batch: int) -> torch.Tensor:
        """Rows start .. start + len(images) of self(key, x), x a batch
        of `batch` images whose rows those are: the whole batch's draws,
        this share's rows of them (data parallelism)."""
        n = images.shape[0]
        return self._apply(images, [
            a[start:start + n] if a is not None else None
            for a in self._draw([key], batch)])


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

    def __init__(self, backend: str, apply, apply_masked=None):
        self.backend = backend
        # ((B, 2) uint32 keys, images, hw=None) -> images
        self._apply = apply
        # the bucketed form, where it is not apply with hw
        self._apply_masked = apply_masked or apply

    def __call__(self, key, images: torch.Tensor) -> torch.Tensor:
        return self._apply(prng.split(key, images.shape[0]), images)

    def keyed(self, keys, images: torch.Tensor) -> torch.Tensor:
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if keys.shape[0] != images.shape[0]:
            raise ValueError('one key per image')
        return self._apply(prng.split(keys, 1)[:, 0], images)

    def masked(self, keys, images: torch.Tensor, hw) -> torch.Tensor:
        """keyed, with hw the (B, 2) valid (h, w) per image (host)."""
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        if keys.shape[0] != images.shape[0]:
            raise ValueError('one key per image')
        return self._apply_masked(prng.split(keys, 1)[:, 0], images,
                                  G._hw_rows(hw, images.shape[0]))

    def share(self, key, images: torch.Tensor, start: int,
              batch: int) -> torch.Tensor:
        """Rows start .. start + len(images) of self(key, x), x a batch
        of `batch` images whose rows those are."""
        keys = prng.split(key, batch)[start:start + images.shape[0]]
        return self._apply(keys, images)


# kinds whose `_wavelet` variant denoises the noisy floats; the others
# cast to u8 first (`pipeline.py:126-127`)
_WAVELET_ON_FLOAT = {Kind.GAUSSIAN, Kind.SAP, Kind.SPECKLE, Kind.UNIFORM,
                     Kind.GAMMA, Kind.RAYLEIGH}


# the per-spec denoise and the post-pass filters: (image, round_u8)
_FILTERS = {
    Denoise.GAUS_BLUR: lambda im, r: stencils.gaussian_blur3(im, round_u8=r),
    Denoise.MEAN: lambda im, r: stencils.mean3(im, round_u8=r),
    Denoise.MEDIAN: lambda im, r: stencils.median3(im),
    Denoise.BILATERAL: lambda im, r: stencils.bilateral(im),
}


def _noisy(spec: NoiseSpec, keys, img: torch.Tensor, hw=None, level=None,
           fast: bool = False):
    """The generator of one spec over (B, H, W, 3) float32 u8-domain
    images, one key each: (noisy images, 'unit' or 'u8' domain).  hw:
    per image valid (h, w) host ints, for the generators whose raster
    depends on it (the elementwise ones need none).  level: a float32
    level in place of spec.level (a mix entry's, `_group_specs`); each
    generator computes with its level in float32, so a traced level and
    a constant one give the same bits, as in the reference.  fast: the
    counter-hash draws (`fast_bits`)."""
    kind = spec.kind
    lvl = spec.level if level is None else float(np.float32(level))
    if kind == Kind.GAUSSIAN:
        if spec.is_random_level:
            kl, kn = np.moveaxis(prng.split(keys), -2, 0)
            idx = prng.randint(kl, (), 0, len(GAUSSIAN_RANDOM_LEVELS))
            var = torch.from_numpy(np.asarray(
                GAUSSIAN_RANDOM_LEVELS, np.float32)[idx]).to(img.device)
        else:
            kn, var = keys, lvl
        return G.gaussian(kn, img, var, fast_bits=fast), 'unit'
    if kind == Kind.POISSON:
        return G.poisson(keys, img, fast_bits=fast), 'unit'
    if kind == Kind.SAP:
        return G.salt_and_pepper(keys, img, lvl, fast_bits=fast), 'unit'
    if kind == Kind.SPECKLE:
        return G.speckle(keys, img, lvl, fast_bits=fast), 'unit'
    if kind == Kind.UNIFORM:
        return G.uniform_add(keys, img, lvl, fast_bits=fast), 'unit'
    if kind == Kind.GAMMA:
        return G.gamma_add(keys, img, lvl, fast_bits=fast), 'unit'
    if kind == Kind.RAYLEIGH:
        return G.rayleigh_add(keys, img, lvl, fast_bits=fast), 'unit'
    if kind == Kind.BROWNIAN:
        return G.brownian(keys, img, lvl, hw, fast_bits=fast), 'u8'
    if kind == Kind.PERIODIC:
        return G.periodic(img, lvl, hw), 'u8'
    if kind == Kind.QUANT:
        return quantize_colors(keys, img, int(lvl), hw), 'u8'
    if kind == Kind.BLOOM:
        params = bloom_params(keys, img.shape[1], img.shape[2], hw)
        return bloom_batched(img, torch.from_numpy(params).to(
            img.device)), 'u8'
    if kind == Kind.SHADER:
        return G.shader(img), 'u8'
    return img, 'u8'                                    # ORIGINAL


def _wavelet_u8(images01: torch.Tensor, hw=None) -> torch.Tensor:
    """The wavelet denoiser over (B, H, W, 3) unit floats, then the numpy
    cast of 255 * out (truncate, wrap mod 256); hw: per-image valid (h,
    w), host ints, or None."""
    return G.wrap_cast_u8(255.0 * denoise_wavelet_batched(images01, hw=hw))


def apply_spec(spec: NoiseSpec, keys, images: torch.Tensor,
               hw=None, level=None, fast: bool = False) -> torch.Tensor:
    """One (kind, level, denoise) combination over (B, H, W, 3) float32
    u8-domain images with one key each ((B, 2) uint32), hw, level and
    fast as `_noisy`.  Returns u8-domain float32, or the [0, 1] floats of
    plain gaussian (a reference quirk)."""
    noisy, dom = _noisy(spec, keys, images, hw, level, fast)
    u8 = G.wrap_cast_u8(255.0 * noisy) if dom == 'unit' else noisy
    d = spec.denoise
    if d == Denoise.NONE:
        if spec.unit_float_output and spec.kind == Kind.GAUSSIAN:
            return noisy
        return u8
    if d == Denoise.WAVELET:
        return _wavelet_u8(noisy if spec.kind in _WAVELET_ON_FLOAT
                           else G.to_unit(u8), hw)
    return _FILTERS[d](u8, True)


def apply_post(denoise: Denoise, images: torch.Tensor,
               unit_float: bool, hw=None) -> torch.Tensor:
    """The standalone denoise post-pass over the batch; the 3x3 filters
    round only for u8-domain inputs; the wavelet takes hw (per-image
    valid (h, w), host ints) for its statistics."""
    if denoise == Denoise.NONE:
        return images
    if denoise == Denoise.WAVELET:
        return _wavelet_u8(images if unit_float else G.to_unit(images), hw)
    if denoise == Denoise.CURVELET:
        # over the whole canvas, hw unused: the reference's bucketed
        # post-pass passes no hw to the curvelet (`pipeline.py:305-316`)
        return curvelet_denoise_batched(images)
    return _FILTERS[denoise](images, not unit_float)


# kinds whose generator takes its level as data: a mix table's entries of
# one such kind share one template, the level riding a per-entry table
_TRACED_LEVEL_KINDS = {Kind.GAUSSIAN, Kind.SAP, Kind.SPECKLE, Kind.UNIFORM,
                       Kind.GAMMA, Kind.RAYLEIGH, Kind.PERIODIC,
                       Kind.BROWNIAN}


def _group_specs(specs):
    """Collapse a mix table to its templates (`pipeline.py:187-220`):
    (templates, traced flags, entry -> template (E,) int32, entry level
    (E,) float32, 0 for the entries whose level is part of the template:
    quant's cluster count, gaussian's random level)."""
    templates, traced_flags, keys = [], [], {}
    eb, el = [], []
    for s in specs:
        traced = s.kind in _TRACED_LEVEL_KINDS and not s.is_random_level
        if traced:
            k = (s.kind, s.denoise, s.unit_float_output, None)
            lvl = float(s.level)
        else:
            k = (s.kind, s.denoise, s.unit_float_output, s.level)
            lvl = 0.0
        if k not in keys:
            keys[k] = len(templates)
            templates.append(s)
            traced_flags.append(traced)
        eb.append(keys[k])
        el.append(lvl)
    return (templates, traced_flags, np.asarray(eb, np.int32),
            np.asarray(el, np.float32))


def _apply_specs_batched(specs, keys, images: torch.Tensor,
                         hw=None, fast: bool = False) -> torch.Tensor:
    """Per-image spec application over a batch of (B, H, W, 3) float32
    images with one key each; hw and fast as `_noisy`.  One spec: every
    image.  A mix table: the mix scan, per image `kc, ka = split(k)`, the
    entry `randint(kc, (), 0, E)`, then that entry's template with key ka
    and, for the traced kinds, its level as float32.  The images that drew the
    same template and level run as one batch; each image's output is the
    one it gets alone."""
    if len(specs) == 1:
        return apply_spec(specs[0], keys, images, hw, fast=fast)
    templates, traced, eb, el = _group_specs(specs)
    branch, level, _, ka = entry_draws(keys, eb, el)
    rows = G._hw_rows(hw, images.shape[0])
    out = torch.empty_like(images)
    groups = {}
    for i, (t, lv) in enumerate(zip(branch.tolist(), level.tolist())):
        groups.setdefault((t, lv if traced[t] else None), []).append(i)
    for (t, lv), ids in groups.items():
        sel = torch.tensor(ids, device=images.device)
        out[sel] = apply_spec(
            templates[t], ka[ids], images[sel],
            None if rows is None else [rows[i] for i in ids],
            None if lv is None else np.float32(lv), fast)
    return out


def _post_batched_for(plan: NoisePlan, unit_float: bool):
    """The plan's post-pass over a batch, the same filter for every
    image; hw as `apply_post`."""
    def post(out, hw=None):
        return apply_post(plan.post_denoise, out, unit_float, hw)
    return post


def _mix_pipeline(plan: NoisePlan) -> _PerImagePipeline:
    """The fused mix kernels; the bucketed form is the mix scan, then the
    post-pass over the canvas (a bilateral one through the bilateral
    kernel, as the fused route's)."""
    kinds, eb, el = plan_tables(plan.specs)
    bilateral = plan.post_denoise == Denoise.BILATERAL
    post = _post_batched_for(plan,
                             all(s.unit_float_output for s in plan.specs))

    def apply(keys, images):
        args = mix_prologue(keys, images, kinds, eb, el)
        if bilateral:
            return fused_mix_bilateral(_to_u8(images), *args, kinds)
        return post(fused_mix_noise(_to_u8(images), *args, kinds))

    def apply_masked(keys, images, hw):
        out = _apply_specs_batched(plan.specs, keys,
                                   images.to(torch.float32), hw)
        return bilateral_batched(out) if bilateral else post(out, hw)

    return _PerImagePipeline(
        'cuda:fused_mix' + ('+bilateral' if bilateral else ''), apply,
        apply_masked)


def _bilateral_pipeline(spec: NoiseSpec, n_stages: int,
                        fast: bool = False) -> _PerImagePipeline:
    """The generator without its bilateral, then each bilateral stage (the
    spec's and the post-pass) as one pass of the bilateral kernel over
    the batch; fast: the counter-hash draws."""
    stripped = (dataclasses.replace(spec, denoise=Denoise.NONE)
                if spec.denoise == Denoise.BILATERAL else spec)

    def apply(keys, images, hw=None):
        out = _apply_specs_batched((stripped,), keys,
                                   images.to(torch.float32), hw, fast)
        for _ in range(n_stages):
            out = bilateral_batched(out)
        return out

    return _PerImagePipeline(f'cuda:bilateral_x{n_stages}'
                             + ('+fast_rng' if fast else ''), apply)


def _generic_pipeline(plan: NoisePlan, fast: bool = False,
                      route: str = 'cuda:generic') -> _PerImagePipeline:
    """The generator (threefry draws, or the counter hash when fast;
    bloom through the bloom kernel; a mix table through the mix scan),
    its denoise and the post-pass; route names the backend."""
    post = _post_batched_for(plan,
                             all(s.unit_float_output for s in plan.specs))

    def apply(keys, images, hw=None):
        return post(_apply_specs_batched(plan.specs, keys,
                                         images.to(torch.float32), hw,
                                         fast), hw)

    return _PerImagePipeline(route + ('+fast_rng' if fast else ''), apply)


def make_pipeline(plan: NoisePlan | str, mode: str = 'TEST',
                  strict_ref: bool = False, use_kernels: bool | None = None,
                  fast_rng: bool = False):
    """Build the pipeline for a parsed plan (or raw noise string).

    use_kernels is the reference's use_pallas: None or True take the
    routes above on every device; False sends every plan through the
    reference's XLA route (`pipeline.py:584-629`, backend 'xla'): the
    generic route, the sap, gaussian, bilateral-only and mix plans
    included, its draws the threefry stream of the reference's
    generators.  fast_rng: the counter-hash draws on the generic and
    bilateral routes, and on every generator of the XLA route ('+fast_rng'
    in the backend); the fused sap, gaussian and mix routes ignore it, as
    the reference's."""
    fast = bool(fast_rng)
    if isinstance(plan, str):
        plan = parse(plan, mode=mode, strict_ref=strict_ref)
    if use_kernels is False:
        return _generic_pipeline(plan, fast, 'xla')
    specs = plan.specs
    if len(specs) > 1:
        if all(s.denoise == Denoise.NONE and not s.is_random_level
               for s in specs):
            return _mix_pipeline(plan)
        return _generic_pipeline(plan, fast)
    s = specs[0]
    post = plan.post_denoise
    if (s.kind == Kind.SAP and s.denoise == Denoise.MEDIAN
            and post in (Denoise.MEDIAN, Denoise.NONE)):
        return _sap_pipeline(s.level, post == Denoise.MEDIAN)
    if (s.kind == Kind.GAUSSIAN and s.denoise == Denoise.GAUS_BLUR
            and post in (Denoise.GAUS_BLUR, Denoise.NONE)):
        levels = (GAUSSIAN_RANDOM_LEVELS if s.is_random_level
                  else [s.level])
        return _gauss_pipeline(levels, post == Denoise.GAUS_BLUR)
    stages = ((s.denoise == Denoise.BILATERAL)
              + (post == Denoise.BILATERAL))
    if (stages and s.denoise in (Denoise.NONE, Denoise.BILATERAL)
            and post in (Denoise.NONE, Denoise.BILATERAL)):
        return _bilateral_pipeline(s, stages, fast)
    return _generic_pipeline(plan, fast)
