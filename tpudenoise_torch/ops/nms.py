"""Non-maximum suppression (counterpart of `tpudenoise/ops/nms.py`).

* `nms_fixpoint`: exact greedy NMS by fixpoint sweeps over the dense
  suppression matrix of the score-sorted boxes, batched over leading dims
  (the per-class NMS of the test path).
* `nms_packed`: the same, with the suppression matrix packed into int32
  words by `build_suppression_masks_cuda` (the RPN proposal NMS at
  6000 boxes).  Bit b of word [wi, j] says box wi*32+b suppresses box j.

Both iterate alive[j] = valid[j] & !any_{i<j}(M[i, j] & alive[i]) to its
fixpoint, which is the greedy keep set.  Sweeps run in rounds of a few
between checks for change (a sweep past the fixpoint changes nothing), so
the host waits on the device once per round, not once per sweep.

Indices refer to the input order, padded with -1, plus a validity mask.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch import cuda_build

NEG_INF = float(np.finfo(np.float32).min)
_PACK = 32
_SWEEPS_PER_CHECK = 4

# kernel launches, counted where the wrapper launches its kernel
launches = {'suppression_masks': 0}


def _iou_tile(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """IoU of (..., TI, 4) vs (..., N, 4) boxes -> (..., TI, N), +1
    convention, in the operation order of the reference's `_iou_tile`."""
    bx1, by1, bx2, by2 = (rows[..., k, None] for k in range(4))
    x1, y1, x2, y2 = (cols[..., None, :, k] for k in range(4))
    ba = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    w = torch.maximum(zero, torch.minimum(bx2, x2) - torch.maximum(bx1, x1)
                      + 1.0)
    h = torch.maximum(zero, torch.minimum(by2, y2) - torch.maximum(by1, y1)
                      + 1.0)
    inter = w * h
    return inter / ((ba + areas) - inter)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., K*32) bool -> (..., K) int32 words (bit b of word w covers
    element w*32+b)."""
    shape = bits.shape[:-1] + (bits.shape[-1] // _PACK, _PACK)
    shifts = torch.arange(_PACK, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(shape).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def build_suppression_masks(sboxes: torch.Tensor, iou_threshold: float,
                            block: int = 512) -> torch.Tensor:
    """Plain version: (B, N, 4) score-sorted boxes -> (B, N/32, N) int32
    words, one (block, N) IoU tile at a time.  N must be a multiple of 32.
    """
    b, n, _ = sboxes.shape
    if n % _PACK:
        raise ValueError(f'N={n} is not a multiple of {_PACK}')
    boxes = sboxes.to(torch.float32)
    thresh = float(np.float32(iou_threshold))
    j_ids = torch.arange(n, device=boxes.device)
    out = []
    for i0 in range(0, n, block):
        rows = boxes[:, i0:i0 + block]
        m = _iou_tile(rows, boxes) > thresh                  # (B, TI, N)
        i_ids = i0 + torch.arange(rows.shape[1], device=boxes.device)
        m &= i_ids[:, None] < j_ids[None, :]
        out.append(_pack_bits(m.transpose(1, 2)).transpose(1, 2))
    return torch.cat(out, dim=1).contiguous()


def build_suppression_masks_cuda(sboxes: torch.Tensor, iou_threshold: float
                                 ) -> torch.Tensor:
    """(B, N, 4) f32 score-sorted boxes -> (B, N/32, N) int32 words: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4:
        raise ValueError(f'boxes must be (B, N, 4), got {sboxes.shape}')
    if sboxes.dtype != torch.float32:
        raise TypeError(f'boxes must be float32, got {sboxes.dtype}')
    b, n, _ = sboxes.shape
    if n % _PACK:
        raise ValueError(f'N={n} is not a multiple of {_PACK}')
    if sboxes.device.type == 'cpu':
        return build_suppression_masks(sboxes, iou_threshold)
    if sboxes.device.type != 'cuda':
        raise ValueError(f'unsupported device {sboxes.device}')
    sboxes = sboxes.contiguous()
    if sboxes.data_ptr() % 16:          # the kernel reads float4
        sboxes = sboxes.clone()
    words = torch.empty((b, n // _PACK, n), dtype=torch.int32,
                        device=sboxes.device)
    cuda_build.launch('nms_mask', 'suppression_masks', sboxes, words, b, n,
                      float(np.float32(iou_threshold)))
    launches['suppression_masks'] += 1
    return words


def _fixpoint(in_valid: torch.Tensor, suppressed_by) -> torch.Tensor:
    """Iterate alive = in_valid & ~suppressed_by(alive) to its fixpoint."""
    alive = in_valid
    for _ in range(in_valid.shape[-1] + 1):
        prev = alive
        for _ in range(_SWEEPS_PER_CHECK):
            alive = in_valid & ~suppressed_by(alive)
        if torch.equal(alive, prev):
            return alive
    return alive


def _first_kept(alive: torch.Tensor, max_outputs: int) -> torch.Tensor:
    """Positions of the first max_outputs alive entries along the last dim,
    -1 padded (the scatter of the reference's rank trick)."""
    n = alive.shape[-1]
    rank = torch.cumsum(alive.to(torch.int64), -1) - 1
    slot = torch.where(alive, rank, max_outputs)
    keep = torch.full(alive.shape[:-1] + (max_outputs + 1,), -1,
                      dtype=torch.int64, device=alive.device)
    ids = torch.arange(n, device=alive.device).expand_as(alive)
    keep.scatter_(-1, slot.clamp(max=max_outputs), ids)
    return keep[..., :max_outputs]


def _finish(keep_sorted, order):
    mask = keep_sorted >= 0
    if order is not None:
        keep_sorted = torch.where(
            mask, torch.gather(order, -1, keep_sorted.clamp(min=0)), -1)
    return keep_sorted.to(torch.int32), mask


def nms_fixpoint(boxes: torch.Tensor, scores: torch.Tensor,
                 iou_threshold: float, max_outputs: int,
                 valid: torch.Tensor | None = None):
    """Exact greedy NMS over (..., N, 4) boxes and (..., N) scores, dense
    (..., N, N) suppression matrix.  Returns keep (..., max_outputs) int32
    and its mask."""
    n = boxes.shape[-2]
    scores = scores.to(torch.float32)
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes.to(torch.float32), -2,
                          order[..., None].expand(*order.shape, 4))
    in_valid = torch.gather(scores, -1, order) > NEG_INF
    tri = torch.ones((n, n), dtype=torch.bool,
                     device=boxes.device).triu(diagonal=1)      # i < j
    m = ((_iou_tile(sboxes, sboxes) > float(np.float32(iou_threshold)))
         & tri & in_valid[..., None, :] & in_valid[..., :, None])

    def suppressed_by(alive):
        return (m & alive[..., :, None]).any(dim=-2)

    alive = _fixpoint(in_valid, suppressed_by)
    return _finish(_first_kept(alive, max_outputs), order)


def nms_packed(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_outputs: int,
               valid: torch.Tensor | None = None, presorted: bool = False):
    """Exact greedy NMS over (B, N, 4) boxes via the packed suppression
    words.  presorted=True asserts the (masked) scores are already
    non-increasing, as the proposal layer's top-k output is, and skips the
    sort.  Returns keep (B, max_outputs) int32 and its mask."""
    b, n_in, _ = boxes.shape
    tile = 512 if n_in >= 512 else 256
    n = -(-n_in // tile) * tile
    scores = scores.to(torch.float32)
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    boxes = torch.nn.functional.pad(boxes.to(torch.float32),
                                    (0, 0, 0, n - n_in))
    scores = torch.nn.functional.pad(scores, (0, n - n_in), value=NEG_INF)
    if presorted:
        order, sboxes, in_valid = None, boxes, scores > NEG_INF
    else:
        order = torch.argsort(-scores, dim=-1, stable=True)
        sboxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
        in_valid = torch.gather(scores, 1, order) > NEG_INF
    masks = build_suppression_masks_cuda(sboxes, iou_threshold)

    def suppressed_by(alive):
        alive_p = _pack_bits(alive)                         # (B, N/32)
        return ((masks & alive_p[..., None]) != 0).any(dim=1)

    alive = _fixpoint(in_valid, suppressed_by)
    return _finish(_first_kept(alive, max_outputs), order)

