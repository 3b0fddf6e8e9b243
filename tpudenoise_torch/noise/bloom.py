"""Batched sun-flare compositing (counterpart of
`tpudenoise/noise/pallas_bloom.py` `bloom_pallas`, batched over images).

A CUDA tensor launches the kernel of `csrc/bloom.cu`; a CPU tensor runs
the plain version, `generators.bloom_apply_scan`, which performs the same
48 steps with the same float32 operations.
"""

from __future__ import annotations

import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.noise.generators import N_STEPS, bloom_apply_scan

# kernel launches, counted where the wrapper launches its kernel
launches = {'bloom': 0}


def bloom_batched(images: torch.Tensor, params: torch.Tensor
                  ) -> torch.Tensor:
    """images (B, H, W, 3) uint8 or u8-domain float32; params (B, 48, 8)
    float32 from `generators.bloom_params`.  Returns float32."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f'images must be (B, H, W, 3), got {images.shape}')
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f'images must be uint8 or float32, got {images.dtype}')
    b, h, w, _ = images.shape
    if (tuple(params.shape) != (b, N_STEPS, 8)
            or params.dtype != torch.float32
            or params.device != images.device):
        raise ValueError('params must be (B, 48, 8) float32 on the images '
                         'device')
    if images.device.type == 'cpu':
        return bloom_apply_scan(images, params)
    if images.device.type != 'cuda':
        raise ValueError(f'unsupported device {images.device}')
    images, params = images.contiguous(), params.contiguous()
    out = torch.empty(images.shape, dtype=torch.float32,
                      device=images.device)
    suffix = 'u8' if images.dtype == torch.uint8 else 'f32'
    cuda_build.launch('bloom', f'bloom_{suffix}', images, out, params, b, h,
                      w)
    launches['bloom'] += 1
    return out
