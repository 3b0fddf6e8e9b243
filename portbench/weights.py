"""The detector's weights, made on the device by a `torch.Generator`
there: one normal and one uniform draw over every element of the state
dict from a fixed base seed, scaled per tensor, then each element
multiplied by (1 + 0.05 z), z a normal draw from the run's seed
clipped to +-4 (so no element changes sign or reaches zero).

Every seed gets the same network up to that 5% jitter.  Networks drawn
whole from independent seeds do different work: the class head's NMS
kept 15 to 100 boxes an image across seeds, and the evaluation, whose
cost follows the detections, took 69 to 297 ms a row, so seeds changed
a row's time more than two runs of one seed did.  The base seed is one
whose network keeps 100 boxes an image (the cap) in both backbones.

Not the program's `FasterRCNN.init`, which zeroes every resnet conv3 (a
residual unit then starts as the identity, and a comparison on such
weights never exercises conv1-3 and bn1-3 of a unit).  Here every conv,
BN and fc tensor is non-zero (the ranges below are before the jitter):

* conv and fc kernels: He normal, sqrt(2 / fan_in); the first conv of
  the backbone also over the pixels' spread (mean-subtracted u8 values);
* frozen BN: gamma in [0.5, 1), beta and mean N(0, 0.1), var in
  [0.5, 1.5); the BN that closes each residual branch (bn3) has gamma in
  [0.1, 0.3), so 33 residual sums grow the activations by a small
  factor and bf16 stays far from its range limits;
* biases N(0, 0.05);
* the RPN's objectness and the class head's logits are scaled so that
  their scores spread over (0, 1); the RPN's deltas stay a small
  fraction of a box, the class head's a larger one.
"""

from __future__ import annotations

import math

import torch

PIXEL_SPREAD = 50.0        # the spread of a mean-subtracted u8 pixel
BASE_SEED = 6100000011     # a network that keeps 100 boxes an image
JITTER = 0.05
GAINS = {'rpn.rpn_cls_score.weight': 2.0,
         'rpn.rpn_bbox_pred.weight': 0.05,
         'rcnn.cls_score.weight': 2.0,
         'rcnn.bbox_pred.weight': 3.0}
FIRST_CONVS = ('head.conv1.weight', 'head.conv1_1.weight')


def layout(state_dict) -> list:
    """(key, shape) of every tensor of a state dict, in its order."""
    return [(k, tuple(v.shape)) for k, v in state_dict.items()]


def _scale(key: str, shape, z: torch.Tensor, u: torch.Tensor
           ) -> torch.Tensor:
    leaf = key.rsplit('.', 1)[-1]
    if leaf == 'weight':
        fan_in = math.prod(shape[1:])
        std = math.sqrt(2.0 / fan_in) * GAINS.get(key, 1.0)
        if key in FIRST_CONVS:
            std /= PIXEL_SPREAD
        return z * std
    if leaf == 'bias':
        return z * 0.05
    if leaf == 'gamma':
        return (0.1 + 0.2 * u) if '.bn3.' in key else (0.5 + 0.5 * u)
    if leaf in ('beta', 'mean'):
        return z * 0.1
    if leaf == 'var':
        return 0.5 + u
    raise ValueError(f'no rule for tensor {key!r}')


def make(spec, seed: int, device) -> dict:
    """{key: float32 tensor on device} for spec = [(key, shape), ...],
    the same for the same seed and device."""
    sizes = [math.prod(s) for _, s in spec]
    g = torch.Generator(device=device)
    g.manual_seed(BASE_SEED)
    z = torch.randn(sum(sizes), generator=g, device=device)
    z.masked_fill_(z == 0, 1e-3)     # a draw of exactly 0.0 leaves no zero
    u = torch.rand(sum(sizes), generator=g, device=device)
    g.manual_seed(int(seed) % 2**64)
    jitter = 1.0 + JITTER * torch.randn(sum(sizes), generator=g,
                                        device=device).clamp_(-4.0, 4.0)
    out, off = {}, 0
    for (key, shape), n in zip(spec, sizes):
        out[key] = _scale(key, shape, z[off:off + n].view(shape),
                          u[off:off + n].view(shape)) * jitter[
                              off:off + n].view(shape)
        off += n
    return out
