"""Non-maximum suppression (counterpart of `tpudenoise/ops/nms.py`).

* `nms_fixpoint`: exact greedy NMS batched over leading dims (the
  per-class NMS of the test path).  On CPU tensors it iterates fixpoint
  sweeps over the dense suppression matrix of the score-sorted boxes; on
  CUDA tensors it takes the packed route (`nms_fixpoint_packed`).
* `nms_packed`: the same over the suppression matrix packed into int32
  words by `build_suppression_masks_cuda` (the RPN proposal NMS at 6000
  boxes).  Bit b of word [wi, j] says box wi*32+b suppresses box j.
* `nms_dets`: the host-facing form of the reference's `nms_py` for one
  (N, 5) dets array (`cli/reval.py`), through `nms_fixpoint` on the
  device the caller names.
* `nms_py`: the reference's numpy greedy NMS itself (`cli/reval.py
  --device cpu` with `cfg.USE_NATIVE_NMS` off).

The keep set is the greedy one: alive[j] = valid[j] &
!any_{i<j}(M[i, j] & alive[i]).  On the card `greedy_keep` walks the words
once in score order (one block per problem), so NMS never waits on the
host.  Its plain version, for CPU tensors, iterates that equation to its
fixpoint in rounds of a few sweeps between checks for change.

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
launches = {'suppression_masks': 0, 'greedy_keep': 0}
# the walk kernel holds at most this many boxes a problem
MAX_WALK_N = 512 * 24


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


def iou_exceeds(inter: np.ndarray, den: np.ndarray,
                iou_threshold: float) -> np.ndarray:
    """fl(inter / den) > f32(iou_threshold) without the divide, step for
    step as `csrc/nms_mask.cu` decides it (float32 inter and den).

    For den finite and > 0 the quotient rounds above t iff inter > m*den,
    or inter == m*den and the float after t is even (the tie rounds to
    it); m is the midpoint between t and that float, and m*den is exact
    in float64.  Two float32 products bracket m*den first, for den and t
    in [2^-60, 2^60].  Every other den keeps the IEEE divide."""
    f = np.float32
    inter, den = np.asarray(inter, f), np.asarray(den, f)
    t = f(iou_threshold)
    nxt = np.nextafter(t, f(np.inf))
    mid = (np.float64(t) + np.float64(nxt)) * 0.5
    even = (nxt.view(np.uint32) & 1) == 0
    with np.errstate(all='ignore'):
        by_div = inter / den > t
        hi, lo = t * f(1 + 2.0**-19), t * f(1 - 2.0**-19)
        lhs, rhs = inter.astype(np.float64), mid * den.astype(np.float64)
        exact = (lhs > rhs) | ((lhs == rhs) & even)
        band = (2.0**-60 <= t <= 2.0**60) & (den >= f(2.0**-60)) & (
            den <= f(2.0**60))
        exact = np.where(band & (inter > den * hi), True,
                         np.where(band & (inter < den * lo), False, exact))
    use = np.isfinite(mid) & (den > 0) & np.isfinite(den)
    return np.where(use, exact, by_div)


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


def greedy_keep_plain(words: torch.Tensor, in_valid: torch.Tensor,
                      max_outputs: int) -> torch.Tensor:
    """Plain version of `greedy_keep`: fixpoint sweeps over the packed
    words, then the first max_outputs alive positions."""
    def suppressed_by(alive):
        alive_p = _pack_bits(alive)                         # (P, N/32)
        return ((words & alive_p[..., None]) != 0).any(dim=1)

    return _first_kept(_fixpoint(in_valid, suppressed_by), max_outputs)


def greedy_keep(words: torch.Tensor, in_valid: torch.Tensor,
                max_outputs: int) -> torch.Tensor:
    """(P, N/32, N) int32 suppression words of score-sorted boxes and their
    (P, N) bool validity -> (P, max_outputs) sorted positions of the
    greedy keep set, -1 padded: the walk kernel for CUDA tensors (int32,
    no host synchronisation), the plain version for CPU tensors
    (int64)."""
    p, nw, n = words.shape
    if words.dtype != torch.int32 or in_valid.dtype != torch.bool:
        raise TypeError(f'need int32 words and bool validity, got '
                        f'{words.dtype} and {in_valid.dtype}')
    if nw * _PACK != n or in_valid.shape != (p, n):
        raise ValueError(f'words {tuple(words.shape)} and validity '
                         f'{tuple(in_valid.shape)} do not agree')
    if max_outputs < 1:
        raise ValueError(f'max_outputs={max_outputs} must be positive')
    if words.device.type == 'cpu':
        return greedy_keep_plain(words, in_valid, max_outputs)
    if words.device.type != 'cuda':
        raise ValueError(f'unsupported device {words.device}')
    if n > MAX_WALK_N:
        raise ValueError(f'N={n} exceeds the walk kernel\'s {MAX_WALK_N}')
    keep = torch.empty((p, max_outputs), dtype=torch.int32,
                       device=words.device)
    cuda_build.launch('nms_mask', 'greedy_keep', words.contiguous(),
                      in_valid.contiguous(), keep, p, n, max_outputs)
    launches['greedy_keep'] += 1
    return keep


def _finish(keep_sorted, order):
    mask = keep_sorted >= 0
    if order is not None:
        keep_sorted = torch.where(mask, torch.gather(
            order, -1, keep_sorted.clamp(min=0).to(torch.int64)), -1)
    return keep_sorted.to(torch.int32), mask


def _sort_boxes(boxes, scores, valid):
    """Scores masked by valid, their stable descending order, the boxes in
    that order and which sorted positions are valid."""
    scores = scores.to(torch.float32)
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes.to(torch.float32), -2,
                          order[..., None].expand(*order.shape, 4))
    return order, sboxes, torch.gather(scores, -1, order) > NEG_INF


def nms_fixpoint(boxes: torch.Tensor, scores: torch.Tensor,
                 iou_threshold: float, max_outputs: int,
                 valid: torch.Tensor | None = None):
    """Exact greedy NMS over (..., N, 4) boxes and (..., N) scores.
    Returns keep (..., max_outputs) int32 and its mask.  CPU tensors take
    the dense (..., N, N) suppression matrix and its fixpoint; CUDA
    tensors `nms_fixpoint_packed` (the same keep set)."""
    if boxes.device.type == 'cuda':
        return nms_fixpoint_packed(boxes, scores, iou_threshold,
                                   max_outputs, valid)
    n = boxes.shape[-2]
    order, sboxes, in_valid = _sort_boxes(boxes, scores, valid)
    tri = torch.ones((n, n), dtype=torch.bool,
                     device=boxes.device).triu(diagonal=1)      # i < j
    m = ((_iou_tile(sboxes, sboxes) > float(np.float32(iou_threshold)))
         & tri & in_valid[..., None, :] & in_valid[..., :, None])

    def suppressed_by(alive):
        return (m & alive[..., :, None]).any(dim=-2)

    alive = _fixpoint(in_valid, suppressed_by)
    return _finish(_first_kept(alive, max_outputs), order)


def nms_fixpoint_packed(boxes: torch.Tensor, scores: torch.Tensor,
                        iou_threshold: float, max_outputs: int,
                        valid: torch.Tensor | None = None):
    """`nms_fixpoint` through the packed words: the leading dims flatten
    into P problems, N pads up to a multiple of 32 with invalid boxes,
    then kernel 3 and the walk (their plain versions on CPU tensors)."""
    lead, n_in = boxes.shape[:-2], boxes.shape[-2]
    n = -(-n_in // _PACK) * _PACK
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    valid = valid.expand(*lead, n_in).reshape(-1, n_in)
    boxes = boxes.reshape(-1, n_in, 4)
    scores = scores.reshape(-1, n_in)
    pad = n - n_in
    boxes = torch.nn.functional.pad(boxes.to(torch.float32), (0, 0, 0, pad))
    scores = torch.nn.functional.pad(scores.to(torch.float32), (0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    order, sboxes, in_valid = _sort_boxes(boxes, scores, valid)
    words = build_suppression_masks_cuda(sboxes, iou_threshold)
    keep, mask = _finish(greedy_keep(words, in_valid, max_outputs), order)
    return (keep.reshape(*lead, max_outputs),
            mask.reshape(*lead, max_outputs))


def nms_packed(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_outputs: int,
               valid: torch.Tensor | None = None, presorted: bool = False):
    """Exact greedy NMS over (B, N, 4) boxes via the packed suppression
    words and `greedy_keep`.  presorted=True asserts the (masked) scores
    are already non-increasing, as the proposal layer's top-k output is,
    and skips the sort.  Returns keep (B, max_outputs) int32 and its
    mask."""
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
        order, sboxes, in_valid = _sort_boxes(boxes, scores, None)
    masks = build_suppression_masks_cuda(sboxes, iou_threshold)
    return _finish(greedy_keep(masks, in_valid, max_outputs), order)


def nms_dets(dets: np.ndarray, thresh: float, device='cuda') -> list:
    """The reference's `nms_py` (`tpudenoise/ops/nms.py:380-403`) for one
    (N, 5) [x1, y1, x2, y2, score] array: the kept indices in greedy
    order, +1 box convention, a box kept where its IoU with every kept
    box is <= thresh.  It runs as `nms_fixpoint` on `device` (on the card
    kernel 3 and the walk; on the CPU their plain versions), in f32.
    Scores that tie are taken in input order (a stable sort); `nms_py`'s
    `argsort()[::-1]` takes tied scores in an order numpy's sort leaves,
    so on ties the two may keep other boxes."""
    dets = np.asarray(dets, np.float32).reshape(-1, 5)
    n = dets.shape[0]
    if n == 0:
        return []
    if n > MAX_WALK_N:
        raise ValueError(f'nms_dets takes at most {MAX_WALK_N} boxes')
    t = torch.from_numpy(np.ascontiguousarray(dets)).to(device)
    keep, mask = nms_fixpoint(t[None, :, :4], t[None, :, 4], thresh, n)
    return keep[mask].tolist()


def nms_py(dets: np.ndarray, thresh: float) -> list:
    """The reference's pure-numpy greedy NMS (`py_cpu_nms`) over (N, 5)
    [x1, y1, x2, y2, score] rows: the kept indices in greedy order.  Tied
    scores go in the order `argsort()[::-1]` leaves them."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
