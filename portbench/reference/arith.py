"""How the reference computes.  'f32' is the reference itself: float32,
TF32 off.  'control' is the step below the precision each stage of the
configuration states, the step a later change would be tempted by:

* the detector's convs and fcs (stated: bf16 compute) in fp8 (e4m3):
  both operands rounded to float8_e4m3fn under a per-tensor scale, the
  products summed in float32;
* the prep's resize (stated: float32 with TF32 off) with its operands
  rounded to TF32 (10 mantissa bits);
* the detections' decode and scores (stated: float32) in bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits (to nearest)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    def __init__(self, mode: str = 'f32'):
        if mode not in ('f32', 'control'):
            raise ValueError(f'unknown arithmetic {mode!r}')
        self.mode = mode
        self.low = mode == 'control'

    def conv(self, x, w, b=None, stride: int = 1, padding: int = 0):
        if self.low:
            x, w = fp8(x), fp8(w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def linear(self, x, w, b=None):
        if self.low:
            x, w = fp8(x), fp8(w)
        return F.linear(x, w, b)

    def resize_operand(self, t):
        return tf32(t) if self.low else t

    def decode(self, t):
        return t.to(torch.bfloat16).to(torch.float32) if self.low else t
