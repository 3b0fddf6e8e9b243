# Frozen copy of tpudenoise_torch/noise/spec.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""The `{noise}_{denoise}_var{level}` string grammar (the port's own copy
of `tpudenoise/noise/spec.py`, field for field; the port imports nothing
of the JAX package).

`parse(noise_string, mode)` -> NoisePlan, with the reference's
substring-priority dispatch, per-kind level vocabularies, mix tables and
quirks:
  * TEST mode with strict_ref: 'sap' and 'quant' fall through to the
    original image; default (strict_ref=False) follows the TRAIN pipeline,
    where both are active.
  * a top-level 'gaussian' draws its level per image from
    GAUSSIAN_RANDOM_LEVELS whatever var it names (level -1 marks it).
  * unknown noise falls back to gaussian_var0.1 + mean blur.
  * TRAIN mix: 'bloom' runs the shader.
  * gaussian with no denoise returns the float [0, 1] image
    (`unit_float_output`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Kind(enum.IntEnum):
    ORIGINAL = 0
    GAUSSIAN = 1
    POISSON = 2
    SAP = 3
    SPECKLE = 4
    QUANT = 5
    UNIFORM = 6
    BROWNIAN = 7
    PERIODIC = 8
    GAMMA = 9
    RAYLEIGH = 10
    BLOOM = 11
    SHADER = 12


class Denoise(enum.IntEnum):
    NONE = 0
    WAVELET = 1
    GAUS_BLUR = 2
    MEAN = 3
    MEDIAN = 4
    BILATERAL = 5
    CURVELET = 6


# per-kind level vocabulary: (substring, value) in match order
# (ref test.py level ladders; BASELINE.md noise intensity grid)
LEVELS = {
    Kind.GAUSSIAN: [('var0.1', 0.1), ('var1.0', 1.0), ('var1.5', 1.5)],
    Kind.SAP: [('var0.2', 0.2), ('var0.4', 0.4), ('var0.8', 0.8)],
    Kind.SPECKLE: [('var0.5', 0.5), ('var1.0', 1.0), ('var2.0', 2.0)],
    Kind.QUANT: [('var10', 10), ('var7', 7), ('var3', 3)],  # var10 first:
    # 'var1' is not in the grammar; longest-match keeps var10 from matching
    # var1/var0 prefixes
    Kind.UNIFORM: [('var0.2', 0.2), ('var0.6', 0.6), ('var1.2', 1.2)],
    Kind.BROWNIAN: [('var0.9', 0.9), ('var0.09', 0.09), ('var0.009', 0.009)],
    Kind.PERIODIC: [('var3.14', 3.14159265358979), ('var100', 100.0),
                    ('varsize', -1.0)],  # -1 => amplitude = image size
    Kind.GAMMA: [('var0.05', 0.05), ('var0.1', 0.1), ('var0.2', 0.2),
                 ('var0.3', 0.3)],  # var0.3 appears in curvelet mix lists
    Kind.RAYLEIGH: [('var0.1', 0.1), ('var0.2', 0.2), ('var0.3', 0.3)],
}

# reference substring-match order for 'varX' within a kind: the code checks
# e.g. var0.1 / var1.0 / var1.5 with elif, i.e. FIRST match in list order;
# but note var0.09 contains 'var0.9'?  No: 'var0.9' in 'var0.09' is False;
# 'var0.09' in 'var0.009' is False.  The ladders are prefix-unambiguous
# except QUANT where 'var10' would contain neither 'var3' nor 'var7'. The
# reference checks var3 -> var7 -> var10, and 'var10' does not contain
# 'var3'/'var7', so order is immaterial there too.

# reference checks brownian levels in order var0.9, var0.09, var0.009 — and
# 'var0.9' IS a substring of neither. But 'var0.09' contains 'var0.9'? No
# ('var0.09' has chars v,a,r,0,.,0,9 — 'var0.9' is not a contiguous
# substring). Order preserved anyway.


# mix lists: (ref test.py:1612-1639 for TEST; minibatch.py:1518-1547 TRAIN)
TEST_MIX = {
    'var_low': ['gaussian_var0.1', 'poisson', 'speckle_var0.5',
                'sap_var0.2', 'uniform_var0.2', 'gamma_var0.05',
                'rayleigh_var0.1', 'periodic_var3.14', 'brownian_var0.9',
                'quant_var3', 'original', 'bloom', 'shader'],
    'var_medium': ['gaussian_var1.0', 'poisson', 'speckle_var1.0',
                   'sap_var0.4', 'uniform_var0.6', 'gamma_var0.1',
                   'rayleigh_var0.2', 'periodic_var100', 'brownian_var0.09',
                   'quant_var7', 'original', 'shader', 'bloom'],
    'var_high': ['gaussian_var1.5', 'poisson', 'speckle_var2.0',
                 'sap_var0.8', 'uniform_var1.2', 'gamma_var0.2',
                 'rayleigh_var0.3', 'periodic_varsize', 'brownian_var0.009',
                 'quant_var10', 'original', 'shader', 'bloom'],
    'var_all': ['gaussian_var0.1', 'poisson', 'speckle_var0.5',
                'sap_var0.2', 'uniform_var0.2', 'gamma_var0.05',
                'gamma_var0.05', 'rayleigh_var0.2',
                'rayleigh_var0.1', 'periodic_var3.14', 'brownian_var0.9',
                'quant_var3', 'gamma_var0.1', 'rayleigh_var0.1',
                'gaussian_var1.0', 'poisson', 'speckle_var1.0',
                'sap_var0.4', 'uniform_var0.6', 'gamma_var0.1', 'shader',
                'original', 'shader', 'bloom',
                'rayleigh_var0.2', 'periodic_var100', 'brownian_var0.09',
                'quant_var7',
                'gaussian_var1.5', 'poisson', 'speckle_var2.0',
                'sap_var0.8', 'uniform_var1.2', 'gamma_var0.2', 'shader',
                'original',
                'rayleigh_var0.3', 'periodic_varsize', 'brownian_var0.009',
                'quant_var10', 'original', 'shader'],
}

TRAIN_MIX = {
    'var_low': ['gaussian_var0.1', 'poisson', 'speckle_var0.5',
                'sap_var0.2', 'uniform_var0.2', 'gamma_var0.05',
                'rayleigh_var0.1', 'periodic_var3.14', 'brownian_var0.9',
                'quant_var10', 'original', 'bloom', 'shader'],
    'var_medium': ['gaussian_var1.0', 'poisson', 'speckle_var1.0',
                   'sap_var0.4', 'uniform_var0.6', 'gamma_var0.1',
                   'rayleigh_var0.2', 'periodic_var100', 'brownian_var0.09',
                   'quant_var7', 'original', 'bloom', 'shader'],
    'var_high': ['gaussian_var1.5', 'poisson', 'speckle_var2.0',
                 'sap_var0.8', 'uniform_var1.2', 'gamma_var0.2',
                 'rayleigh_var0.3', 'periodic_varsize', 'brownian_var0.009',
                 'quant_var3', 'original', 'bloom', 'shader'],
    'var_all': ['gaussian_var0.1', 'poisson', 'speckle_var0.5',
                'sap_var0.2', 'uniform_var0.2', 'gamma_var0.05',
                'rayleigh_var0.1', 'periodic_var3.14', 'brownian_var0.9',
                'quant_var3', 'shader', 'bloom',
                'gaussian_var1.0', 'poisson', 'speckle_var1.0',
                'sap_var0.4', 'uniform_var0.6', 'gamma_var0.1', 'original',
                'shader', 'bloom',
                'rayleigh_var0.2', 'periodic_var100', 'brownian_var0.09',
                'quant_var7',
                'gaussian_var1.5', 'poisson', 'speckle_var2.0',
                'sap_var0.8', 'uniform_var1.2', 'gamma_var0.2',
                'rayleigh_var0.3', 'periodic_varsize', 'brownian_var0.009',
                'quant_var10', 'original', 'shader', 'bloom'],
}

# curvelet pre-noise list (ref test.py:1820-1827 / minibatch.py:1664-1669)
CURVELET_MIX = ['gaussian_var1.0', 'poisson', 'speckle_var1.0',
                'sap_var0.4', 'uniform_var0.6', 'gamma_var0.3',
                'rayleigh_var0.2', 'periodic_var100', 'brownian_var0.09',
                'quant_var7', 'original', 'shader']

GAUSSIAN_RANDOM_LEVELS = [0.1, 1.0, 1.5]  # test.py:1678 / minibatch.py:1578


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """One resolved (noise kind, level, denoise) combination."""
    kind: Kind
    level: float = 0.0
    denoise: Denoise = Denoise.NONE
    # gaussian-plain quirk: the generator returns the float [0,1] image
    # instead of uint8 (ref test.py:290-305)
    unit_float_output: bool = False

    @property
    def is_random_level(self) -> bool:
        # gaussian level is drawn per image from GAUSSIAN_RANDOM_LEVELS
        return self.kind == Kind.GAUSSIAN and self.level < 0


@dataclasses.dataclass(frozen=True)
class NoisePlan:
    """A parsed noise string: either a single spec or a mix over specs,
    plus an optional standalone denoise post-pass."""
    specs: tuple  # tuple[NoiseSpec, ...]; >1 entries = per-image mix
    # standalone post-pass on the full `noise` string
    # (TRAIN: all 5 filters active, minibatch.py:1636-1663;
    #  TEST: only wavelet active, test.py:1787-1819)
    post_denoise: Denoise = Denoise.NONE
    raw: str = ''


def _parse_denoise(s: str) -> Denoise:
    if 'wavelet' in s:
        return Denoise.WAVELET
    if 'gaus_blur' in s:
        return Denoise.GAUS_BLUR
    if 'mean' in s:
        return Denoise.MEAN
    if 'median' in s:
        return Denoise.MEDIAN
    if 'bilateral' in s:
        return Denoise.BILATERAL
    return Denoise.NONE


def _parse_level(kind: Kind, s: str) -> Optional[float]:
    for sub, val in LEVELS.get(kind, []):
        if sub in s:
            return float(val)
    return None


_KIND_ORDER = [  # reference elif chain order (test.py:1641-1760)
    ('gaussian', Kind.GAUSSIAN), ('poisson', Kind.POISSON),
    ('sap', Kind.SAP), ('speckle', Kind.SPECKLE),
    ('periodic', Kind.PERIODIC), ('brownian', Kind.BROWNIAN),
    ('quant', Kind.QUANT), ('uniform', Kind.UNIFORM),
    ('gamma', Kind.GAMMA), ('rayleigh', Kind.RAYLEIGH),
    ('bloom', Kind.BLOOM), ('shader', Kind.SHADER),
    ('original', Kind.ORIGINAL),
]


def _spec_for(noise_type: str, mode: str, strict_ref: bool,
              in_mix: bool = False) -> NoiseSpec:
    """Resolve one noise_type token (e.g. 'speckle_median_var1.0')."""
    denoise = _parse_denoise(noise_type)
    for sub, kind in _KIND_ORDER:
        if sub in noise_type:
            if kind == Kind.GAUSSIAN:
                # top-level gaussian randomizes the level per image
                # (test.py:1678-1682); inside a mix the token's var is used
                # directly. level<0 marks randomized.
                level = (_parse_level(kind, noise_type) or 0.1) if in_mix \
                    else -1.0
                return NoiseSpec(
                    kind, level=level, denoise=denoise,
                    unit_float_output=(denoise == Denoise.NONE))
            if strict_ref and mode == 'TEST' and kind in (Kind.SAP,
                                                          Kind.QUANT):
                # test.py:1691-1697,1719-1725 fall through to original
                return NoiseSpec(Kind.ORIGINAL)
            if kind in (Kind.ORIGINAL, Kind.BLOOM, Kind.SHADER,
                        Kind.POISSON):
                if kind == Kind.BLOOM and mode == 'TRAIN' and strict_ref:
                    # minibatch.py:1572-1573: train 'bloom' (in mix) runs
                    # the shader — only inside mix; single-noise 'bloom'
                    # uses add_bloom. Handled at mix expansion.
                    pass
                return NoiseSpec(kind, denoise=denoise)
            level = _parse_level(kind, noise_type)
            if level is None:
                # no recognized level => reference generators return the
                # unbound 'im' (crash) — we resolve to original instead,
                # documented deviation
                return NoiseSpec(Kind.ORIGINAL)
            return NoiseSpec(kind, level=level, denoise=denoise)
    # unknown noise: gaussian_var0.1 + mean blur fallback (test.py:1757-1768)
    return NoiseSpec(Kind.GAUSSIAN, level=0.1, denoise=Denoise.MEAN,
                     unit_float_output=False)


def parse(noise: str, mode: str = 'TEST',
          strict_ref: bool = False) -> NoisePlan:
    """Parse the full `--noise` string into a typed plan.

    mode: 'TRAIN' or 'TEST' (selects mix tables and quirk set).
    strict_ref: reproduce test-path quirks exactly (sap/quant fallthrough,
      disabled post-pass filters); default False = train-pipeline semantics,
      the README contract.
    """
    noise = noise or 'original'
    if 'mix' in noise:
        table = TRAIN_MIX if mode == 'TRAIN' else TEST_MIX
        for key in ('var_low', 'var_medium', 'var_high', 'var_all'):
            if key in noise:
                tokens = table[key]
                break
        else:
            tokens = ['original']
        specs = []
        for t in tokens:
            s = _spec_for(t, mode, strict_ref, in_mix=True)
            if (mode == 'TRAIN' and 'bloom' in t
                    and s.kind == Kind.BLOOM):
                s = NoiseSpec(Kind.SHADER)  # minibatch.py:1572-1573 quirk
            specs.append(s)
        # the standalone post-pass keys off the FULL noise string in the
        # reference, mix or not (minibatch.py:1636-1663; TEST: wavelet
        # only, test.py:1787-1819) — e.g. 'noise_mix_var_medium_bilateral'
        # bilateral-filters every mixed image
        if not strict_ref or mode == 'TRAIN':
            post = _parse_denoise(noise)
        else:
            post = (Denoise.WAVELET if 'wavelet' in noise
                    else Denoise.NONE)
        return NoisePlan(tuple(specs), post_denoise=post, raw=noise)

    if 'curvelet' in noise:
        # curvelet: random pre-noise then FFT-curvelet reconstruction
        # (ref test.py:1820-1831; in strict TEST the curvelet output was
        # immediately overwritten by retain_original() — test.py:1831 — a
        # plain bug we do NOT reproduce)
        specs = tuple(_spec_for(t, mode, strict_ref, in_mix=True)
                      for t in CURVELET_MIX)
        return NoisePlan(specs, post_denoise=Denoise.CURVELET, raw=noise)

    spec = _spec_for(noise, mode, strict_ref)

    # standalone denoise post-pass: parsed from the FULL noise string after
    # the generator already applied its own variant — in the reference's
    # train path this double-applies the filter (minibatch.py:1636-1663);
    # reproduce only when the generator path matched a denoise substring.
    if not strict_ref or mode == 'TRAIN':
        post = _parse_denoise(noise)
    else:
        post = Denoise.WAVELET if 'wavelet' in noise else Denoise.NONE
    return NoisePlan((spec,), post_denoise=post, raw=noise)
