"""BayesShrink wavelet denoising, bior1.5, soft threshold, on YCbCr
(counterpart of `tpudenoise/denoise/wavelet.py`, the reference's
`_wavelet` variant: skimage `denoise_wavelet(method='BayesShrink',
mode='soft', wavelet='bior1.5', multichannel=True, convert2ycbcr=True)`).

* A multi-level separable 2-D DWT with half-sample symmetric extension.
  Each 1-D level is a banded matrix with the extension folded in
  (`_analysis_matrix`, `_synthesis_matrix`, numpy, cached per size),
  applied block by block: output blocks of `_JB` coefficients contract
  only their input window (`_analysis_blocks`, `_synthesis_blocks`).
  These are f32 `torch.matmul`s; in the JAX package they are XLA
  einsums, not a Pallas kernel.
* sigma = median(|HH_1|) / 0.67448975 per plane (`_median_nonneg`: the
  jnp.median of the reference, the mean of the two middle order
  statistics for even n, bit for bit), the BayesShrink threshold per
  band and plane, soft thresholding, the inverse DWT.
* Per-plane min/max normalization around the YCbCr transform.  The
  caller's BGR goes into the RGB-defined transform with no channel swap,
  as the reference does.

`hw` (valid extents of bucket-padded canvases) restricts the min/max,
the sigma median and the band variances to the valid region; the
decomposition depth stays the canvas's.

Precision: the matmuls run in true f32 on every device.  TF32 on the
card would cost ~1e-3, far past the 2e-5 of a decomposition and
reconstruction, so `denoise_wavelet*` turn it off
(`harness.set_matmul_precision`) before they run.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpudenoise_torch.ops.color import rgb01_to_ycbcr, ycbcr_to_rgb01
from tpudenoise_torch.utils.transfer import to_device

# bior1.5 filter bank (PyWavelets coefficient convention)
_SQ2 = 1.0 / math.sqrt(2.0)
_A = 0.016572815184059706
_B = 0.12153397801643785
DEC_LO = np.array([_A, -_A, -_B, _B, _SQ2, _SQ2, _B, -_B, -_A, _A],
                  np.float32)
DEC_HI = np.array([0, 0, 0, 0, -_SQ2, _SQ2, 0, 0, 0, 0], np.float32)
REC_LO = np.array([0, 0, 0, 0, _SQ2, _SQ2, 0, 0, 0, 0], np.float32)
REC_HI = np.array([_A, _A, -_B, -_B, _SQ2, -_SQ2, _B, _B, -_A, -_A],
                  np.float32)
_L = 10  # dec_len
# output block width of the banded application
_JB = 128
_EPS = float(np.finfo(np.float32).eps)
_MAX = float(np.finfo(np.float32).max)


def dwt_max_level(n: int, dec_len: int = _L) -> int:
    if n < dec_len - 1:
        return 0
    return int(math.floor(math.log2(n / (dec_len - 1.0))))


def default_levels(h: int, w: int) -> int:
    """skimage's default: the largest common level minus 3, at least 1."""
    return max(min(dwt_max_level(h), dwt_max_level(w)) - 3, 1)


def _refl(i: int, n: int) -> int:
    """Half-sample symmetric extension index map."""
    while i < 0 or i >= n:
        if i < 0:
            i = -1 - i
        if i >= n:
            i = 2 * n - 1 - i
    return i


@functools.lru_cache(maxsize=None)
def _analysis_matrix(n: int) -> np.ndarray:
    """(n, 2m) f32: columns [0, m) give lo, [m, 2m) hi, with out[j] =
    sum_k w[k] * x[_refl(2j + k - (L-2))]."""
    m = (n + _L - 1) // 2
    w_lo = DEC_LO[::-1]
    w_hi = DEC_HI[::-1]
    mat = np.zeros((n, 2 * m), np.float32)
    for j in range(m):
        for k in range(_L):
            i = _refl(2 * j + k - (_L - 2), n)
            mat[i, j] += w_lo[k]
            mat[i, m + j] += w_hi[k]
    return mat


@functools.lru_cache(maxsize=None)
def _synthesis_matrix(m: int, n: int) -> np.ndarray:
    """(2m, n) f32: rows [0, m) weight lo, [m, 2m) hi (the zero-stuffed
    full correlation, trimmed by L-2)."""
    w_lo = REC_LO[::-1]
    w_hi = REC_HI[::-1]
    mat = np.zeros((2 * m, n), np.float32)
    for i in range(m):
        for t in range(n):
            k = 2 * i + 1 - t
            if 0 <= k < _L:
                mat[i, t] += w_lo[k]
                mat[m + i, t] += w_hi[k]
    return mat


@functools.lru_cache(maxsize=None)
def _analysis_blocks(n: int) -> tuple:
    """The banded analysis as (input rows i0:i1, matrix columns c0:c1):
    the whole matrix when m <= 2 * _JB, else lo then hi in _JB-wide
    output blocks, each over the inputs its columns reach."""
    m = (n + _L - 1) // 2
    if m <= 2 * _JB:
        return ((0, n, 0, 2 * m),)
    out = []
    for off in (0, m):
        for j0 in range(0, m, _JB):
            j1 = min(j0 + _JB, m)
            out.append((max(0, 2 * j0 - (_L - 2)), min(n, 2 * (j1 - 1) + 2),
                        off + j0, off + j1))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _synthesis_blocks(m: int, n: int) -> tuple:
    """The banded synthesis as output blocks t0:t1, each the sum of its lo
    and hi terms over coefficient rows i0:i1 (offset by 0 and m)."""
    if n <= 2 * _JB:
        return ((0, n, None, None),)
    out = []
    for t0 in range(0, n, _JB):
        t1 = min(t0 + _JB, n)
        out.append((t0, t1, max(0, (t0 - 1) // 2),
                    min(m, (t1 + _L - 2) // 2 + 1)))
    return tuple(out)


_MATS: dict = {}


def _mat(kind: str, dims: tuple, device) -> torch.Tensor:
    """The numpy band matrix as an f32 tensor on `device`, cached."""
    key = (kind, dims, str(device))
    t = _MATS.get(key)
    if t is None:
        src = (_analysis_matrix(*dims) if kind == 'A'
               else _synthesis_matrix(*dims))
        t = _MATS[key] = torch.from_numpy(src).to(device)
    return t


def _analysis_apply(x: torch.Tensor, n: int, last_axis: bool
                    ) -> torch.Tensor:
    """A(n, 2m) applied along x's row axis (last_axis False: (..., n, w)
    -> (..., 2m, w)) or lane axis (True: (..., h, n) -> (..., h, 2m))."""
    a = _mat('A', (n,), x.device)
    parts = []
    for i0, i1, c0, c1 in _analysis_blocks(n):
        blk = a[i0:i1, c0:c1]
        if last_axis:
            parts.append(torch.matmul(x[..., i0:i1], blk))
        else:
            parts.append(torch.matmul(blk.t(), x[..., i0:i1, :]))
    return parts[0] if len(parts) == 1 else torch.cat(
        parts, dim=-1 if last_axis else -2)


def _synthesis_apply(lohi: torch.Tensor, m: int, n: int, last_axis: bool
                     ) -> torch.Tensor:
    """S(2m, n) applied along lohi's lane axis (last_axis True) or row
    axis (False), size 2m -> n."""
    s = _mat('S', (m, n), lohi.device)
    parts = []
    for t0, t1, i0, i1 in _synthesis_blocks(m, n):
        if i0 is None:
            rows = (slice(0, 2 * m),)
        else:
            rows = (slice(i0, i1), slice(m + i0, m + i1))
        acc = None
        for r in rows:
            blk = s[r, t0:t1]
            y = (torch.matmul(lohi[..., r], blk) if last_axis
                 else torch.matmul(blk.t(), lohi[..., r, :]))
            acc = y if acc is None else acc + y
        parts.append(acc)
    return parts[0] if len(parts) == 1 else torch.cat(
        parts, dim=-1 if last_axis else -2)


def _analysis_flops(n: int, other: int) -> int:
    return sum(2 * (i1 - i0) * (c1 - c0) * other
               for i0, i1, c0, c1 in _analysis_blocks(n))


def _synthesis_flops(m: int, n: int, other: int) -> int:
    return sum(2 * ((2 * m) if i0 is None else 2 * (i1 - i0))
               * (t1 - t0) * other
               for t0, t1, i0, i1 in _synthesis_blocks(m, n))


def matmul_flops(planes: int, h: int, w: int, levels: int | None = None
                 ) -> int:
    """Multiply-add operations (x2) of the banded matmuls of one
    decomposition and reconstruction of `planes` (h, w) planes."""
    levels = default_levels(h, w) if levels is None else levels
    total = 0
    for _ in range(levels):
        mh, mw = (h + _L - 1) // 2, (w + _L - 1) // 2
        total += _analysis_flops(h, w) + _analysis_flops(w, 2 * mh)
        total += _synthesis_flops(mw, w, 2 * mh) + _synthesis_flops(mh, h, w)
        h, w = mh, mw
    return planes * total


def dwt2(x: torch.Tensor):
    """One 2-D DWT level over the last two axes: (..., H, W) -> (aa, (ad,
    da, dd)); leading axes batch."""
    h, w = x.shape[-2], x.shape[-1]
    mh, mw = (h + _L - 1) // 2, (w + _L - 1) // 2
    rows = _analysis_apply(x, h, last_axis=False)           # (..., 2mh, w)
    both = _analysis_apply(rows, w, last_axis=True)         # (..., 2mh, 2mw)
    return both[..., :mh, :mw], (both[..., :mh, mw:], both[..., mh:, :mw],
                                 both[..., mh:, mw:])


def idwt2(aa, details, shape) -> torch.Tensor:
    """Inverse of dwt2 back to `shape`'s last two sizes."""
    ad, da, dd = details
    h, w = shape[-2], shape[-1]
    mh, mw = aa.shape[-2], aa.shape[-1]
    lohi = torch.cat([torch.cat([aa, ad], dim=-1),
                      torch.cat([da, dd], dim=-1)], dim=-2)
    cols = _synthesis_apply(lohi, mw, w, last_axis=True)
    return _synthesis_apply(cols, mh, h, last_axis=False)


def wavedec2(x: torch.Tensor, levels: int):
    """(approx, [details, finest first], [each level's input shape])."""
    coeffs, shapes = [], []
    a = x
    for _ in range(levels):
        shapes.append(tuple(a.shape))
        a, d = dwt2(a)
        coeffs.append(d)
    return a, coeffs, shapes


def waverec2(approx, coeffs, shapes) -> torch.Tensor:
    a = approx
    for d, shp in zip(reversed(coeffs), reversed(shapes)):
        a = idwt2(a, d, shp)
    return a


def _middle(sorted_rows: torch.Tensor, k1: torch.Tensor,
            odd: torch.Tensor) -> torch.Tensor:
    """jnp.median from rows sorted ascending: order statistic k1 where the
    count is odd, else the f32 mean of statistics k1 and k1 + 1."""
    n = sorted_rows.shape[-1]
    m1 = torch.gather(sorted_rows, -1, k1[:, None])[:, 0]
    m2 = torch.gather(sorted_rows, -1,
                      torch.clamp(k1 + 1, max=n - 1)[:, None])[:, 0]
    return torch.where(odd, m1, 0.5 * (m1 + m2))


def _median_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Per-row median of non-negative floats, (P, n) -> (P,), bit for bit
    the reference's (jnp.median: for even n the mean of the two middle
    order statistics; torch.median would return the lower one)."""
    p, n = x.shape
    srt = torch.sort(x.to(torch.float32), dim=-1).values
    k1 = torch.full((p,), (n - 1) // 2, dtype=torch.int64, device=x.device)
    odd = torch.full((p,), n % 2 == 1, dtype=torch.bool, device=x.device)
    return _middle(srt, k1, odd)


def _median_nonneg_masked(x: torch.Tensor, mask: torch.Tensor,
                          nv: torch.Tensor) -> torch.Tensor:
    """`_median_nonneg` over each row's `mask` entries (nv of them):
    invalid entries become the largest finite f32, so they sort above
    every valid one, and the rank is (nv - 1) // 2 per row."""
    srt = torch.sort(torch.where(mask, x.to(torch.float32), _MAX),
                     dim=-1).values
    nv = nv.to(torch.int64)
    return _middle(srt, torch.clamp((nv - 1) // 2, min=0), nv % 2 == 1)


def _soft(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(d) * torch.clamp(torch.abs(d) - t, min=0.0)


def _bayes_threshold_c(d: torch.Tensor, var: torch.Tensor,
                       mask_nv=None) -> torch.Tensor:
    """BayesShrink threshold per plane of (P, H', W') detail bands; mask_nv
    (mask (P, H', W') bool, nv (P,)) restricts the band variance to the
    valid coefficients."""
    if mask_nv is None:
        dvar = torch.mean(d * d, dim=(-2, -1), keepdim=True)
    else:
        mask, nv = mask_nv
        dvar = (torch.sum(torch.where(mask, d * d, 0.0), dim=(-2, -1),
                          keepdim=True)
                / torch.clamp(nv, min=1)[:, None, None].to(torch.float32))
    return var / torch.sqrt(torch.clamp(dvar - var, min=_EPS))


def _level_masks(levels: int, shapes, hw: torch.Tensor) -> list:
    """Per level (finest first) the valid coefficients of bucket-padded
    planes, (mask (P, mh, mw), nv (P,)): coefficient j counts where j <
    ceil(v / 2) of the level's valid extent v.  hw: (P, 2) int."""
    vh, vw = hw[:, 0], hw[:, 1]
    out = []
    for lvl in range(levels):
        h, w = shapes[lvl][-2], shapes[lvl][-1]
        mh, mw = (h + _L - 1) // 2, (w + _L - 1) // 2
        vh = (vh + 1) // 2
        vw = (vw + 1) // 2
        rows = torch.arange(mh, device=hw.device)[None, :, None] \
            < vh[:, None, None]
        cols = torch.arange(mw, device=hw.device)[None, None, :] \
            < vw[:, None, None]
        out.append((rows & cols, vh * vw))
    return out


def denoise_channels(x: torch.Tensor, levels: int,
                     hw: torch.Tensor | None = None) -> torch.Tensor:
    """BayesShrink denoise of a (P, H, W) stack, statistics per plane;
    hw (P, 2) masks them to each plane's valid region (the thresholds
    and the reconstruction still cover the whole canvas)."""
    a, coeffs, shapes = wavedec2(x, levels)
    dd1 = coeffs[0][2]
    flat = torch.abs(dd1).reshape(dd1.shape[0], -1)
    if hw is None:
        masks = None
        sigma = _median_nonneg(flat)
    else:
        masks = _level_masks(levels, shapes, hw)
        m1, nv1 = masks[0]
        sigma = _median_nonneg_masked(flat, m1.reshape(m1.shape[0], -1),
                                      nv1)
    sigma = sigma[:, None, None] / 0.67448975
    var = sigma * sigma
    new = []
    for lvl, bands in enumerate(coeffs):
        mask = None if masks is None else masks[lvl]
        new.append(tuple(_soft(d, _bayes_threshold_c(d, var, mask))
                         for d in bands))
    return waverec2(a, new, shapes)


def _masked_minmax(ycc: torch.Tensor, hw: torch.Tensor):
    """Per-plane min/max of (P, H, W) over each plane's valid (h, w)."""
    h, w = ycc.shape[-2], ycc.shape[-1]
    rows = torch.arange(h, device=ycc.device)[None, :] < hw[:, 0:1]
    cols = torch.arange(w, device=ycc.device)[None, :] < hw[:, 1:2]
    m = rows[:, :, None] & cols[:, None, :]
    inf = float('inf')
    mn = torch.amin(torch.where(m, ycc, inf), dim=(-2, -1), keepdim=True)
    mx = torch.amax(torch.where(m, ycc, -inf), dim=(-2, -1), keepdim=True)
    return mn, mx


def _hw_tensor(hw, b: int, device) -> torch.Tensor:
    """(B, 2) valid extents (host ints, numpy or a tensor) as an int64
    tensor on `device`."""
    if not isinstance(hw, torch.Tensor):
        hw = np.asarray(hw, np.int64)
    t = to_device(hw, device).to(torch.int64).reshape(-1, 2)
    if t.shape[0] != b:
        raise ValueError('one valid (h, w) per image')
    return t


def denoise_wavelet_batched(imgs01: torch.Tensor, levels: int | None = None,
                            hw=None) -> torch.Tensor:
    """skimage's denoise_wavelet (BayesShrink, soft, bior1.5, YCbCr) of
    each image of (B, H, W, 3) floats in [0, 1] (unclipped inputs
    allowed), statistics per image and plane: the (3B, H, W) planes go
    through every matmul at once.  hw: optional (B, 2) valid extents of
    bucket-padded images.  Returns floats (they may leave [0, 1])."""
    from tpudenoise_torch.eval.harness import set_matmul_precision
    set_matmul_precision()
    b, h, w = imgs01.shape[0], imgs01.shape[1], imgs01.shape[2]
    if levels is None:
        levels = default_levels(h, w)
    ycc = rgb01_to_ycbcr(imgs01.to(torch.float32)).permute(0, 3, 1, 2)
    ycc = ycc.reshape(b * 3, h, w)                           # (3B, H, W)
    if hw is None:
        hwp = None
        mn = torch.amin(ycc, dim=(-2, -1), keepdim=True)
        mx = torch.amax(ycc, dim=(-2, -1), keepdim=True)
    else:
        hwp = _hw_tensor(hw, b, ycc.device).repeat_interleave(3, dim=0)
        mn, mx = _masked_minmax(ycc, hwp)
    rng = torch.clamp(mx - mn, min=_EPS)
    d = denoise_channels((ycc - mn) / rng, levels, hw=hwp)
    out = (d * rng + mn).reshape(b, 3, h, w).permute(0, 2, 3, 1)
    return ycbcr_to_rgb01(out)


def denoise_wavelet(img01: torch.Tensor, levels: int | None = None,
                    hw=None) -> torch.Tensor:
    """`denoise_wavelet_batched` of one (H, W, 3) image; hw: optional (2,)
    valid extent."""
    if hw is not None:
        hw = (hw.reshape(1, 2) if isinstance(hw, torch.Tensor)
              else np.asarray(hw, np.int64).reshape(1, 2))
    return denoise_wavelet_batched(img01[None], levels, hw)[0]
