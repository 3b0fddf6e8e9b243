"""The noise-string grammar, shared with the JAX package (jax-free)."""

from tpudenoise.noise.spec import (GAUSSIAN_RANDOM_LEVELS, Denoise, Kind,
                                   NoisePlan, NoiseSpec, parse)

__all__ = ['GAUSSIAN_RANDOM_LEVELS', 'Denoise', 'Kind', 'NoisePlan',
           'NoiseSpec', 'parse']
