# Frozen copy of tpudenoise_torch/core/prng.py for the benchmark's reference: the plain
# versions only, on every device; imports point at the copies beside it.
"""threefry2x32 key operations in numpy, bit-equal to `jax.random`.

The eval harness seeds each image's noise from
`fold_in(PRNGKey(RNG_SEED), image_index)` followed by `randint`
(`tpudenoise/noise/pipeline.py:498-505, 551-560`).  The card has no jax,
so the key algebra is re-implemented here on uint32 numpy arrays,
matching jax 0.9 with `jax_threefry_partitionable=True` (its default):

* `split` and `random_bits` hash the 64-bit iota of the output shape as
  (hi, lo) count pairs; a 32-bit draw is `bits_hi ^ bits_lo`;
* `fold_in(key, d)` hashes the count pair (0, d);
* `randint` draws 2 x 32 bits from `split(key)` and reduces them modulo
  the span with jax's multiplier trick, in wrapping uint32 arithmetic;
* `uniform` and `gumbel` (float32) feed the mix prologue's bloom params
  and k-means init;
* `draw_normal` takes `normal` (sqrt(2) * erf_inv of a uniform in
  [nextafter(-1, 0), 1)) for B keys x N elements on a torch device.

A key is a `(2,)` uint32 array, as `jax.random.PRNGKey` returns.  Every
function also takes a batch of keys, (..., 2), and returns one result per
key along the leading axes, as `jax.vmap` over the keys would.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.noise.transfer import to_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block function on uint32 arrays."""
    k1, k2 = np.asarray(k1, _U32), np.asarray(k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x1, _U32) + ks[0]
    x1 = np.asarray(x2, _U32) + ks[1]
    with np.errstate(over='ignore'):
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(step + 1) % 3]
            x1 = x1 + ks[(step + 2) % 3] + _U32(step + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed in int32 or uint32 range."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f'seed {seed} outside the 32-bit range')
    return np.asarray([0, seed & 0xFFFFFFFF], _U32)


def key_data(key) -> np.ndarray:
    return np.asarray(key, _U32)


def fold_in(key, data) -> np.ndarray:
    """`jax.random.fold_in`; `data` may be an int array (one key per
    element) when `key` is a single key."""
    key = key_data(key)
    d = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(_U32)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], _U32(0), d)
    return np.stack([b1, b2], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` -> (..., num, 2) uint32."""
    key = key_data(key)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32-bit draws of `shape` (`jax.random.bits` for uint32)."""
    key = key_data(key)
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 output
    and int32-range bounds."""
    if not -2**31 <= minval and maxval <= 2**31 - 1:
        raise ValueError('bounds outside the int32 range')
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape).astype(np.uint64)
    lower = random_bits(keys[..., 1, :], shape).astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    span = np.uint64((maxval - minval) & 0xFFFFFFFF if maxval > minval
                     else 1)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult) & mask
    mult = mult % span
    off = (((higher % span) * mult) & mask) + (lower % span)
    off = (off & mask) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def _fma32(a, b, c) -> np.ndarray:
    """f32 a*b + c with one rounding, as XLA's CPU code contracts it: the
    product of two f32 values is exact in f64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform` for float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, then `max(minval, u * (maxval - minval) +
    minval)` with the multiply-add contracted."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def gumbel(key, shape) -> np.ndarray:
    """`jax.random.gumbel` (mode 'low') for float32: -log(-log(u)) with u
    uniform in [tiny, 1).  The uniform draw is bit-equal; each log is
    taken in f64 and rounded, where XLA's CPU log is a polynomial that
    is not correctly rounded, so values agree with jax to an ulp or two
    of max(|value|, 1)."""
    u = uniform(key, shape, np.finfo(np.float32).tiny, 1.0)
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    return (-np.log(-inner.astype(np.float64))).astype(np.float32)


# ------------------------------------------------------------ normals --

# XLA's f32 erf_inv (Giles' single-precision polynomial), coefficients for
# w < 5 and w >= 5, highest power first
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = np.float32(np.sqrt(2))
# `normal` draws u uniform in [nextafter(-1, 0), 1): minval, and the f32
# span maxval - minval, which rounds to 2
NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
NORMAL_SPAN = np.float32(1.0) - NORMAL_LO


# --------------------------------------------------------- device draws --
#
# The noise generators draw whole fields: B keys x N elements (N = H*W*3,
# 1.8M per 600x1000 image), on the images' device, in int64 masked to 32
# bits (torch on the CPU lacks uint32 `>>`).  Element i of key b is
# threefry2x32(key_b, (hi, lo) of i), then bits_hi ^ bits_lo, as
# `random_bits`.

_M32 = 0xFFFFFFFF


def _fma_t(a, b, c):
    """f32 a*b + c rounded once (XLA's contraction), via float64."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def threefry_bits_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(K, 2) int64 key words -> (K, n) int64 32-bit draws."""
    k0, k1 = keys[:, :1] & _M32, keys[:, 1:] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    x0 = (lo >> 32) + ks[0] & _M32          # counter hi word
    x1 = (lo & _M32) + ks[1] & _M32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = x0 + x1 & _M32
            x1 = ((x1 << r) & _M32 | x1 >> (32 - r)) ^ x0
        x0 = x0 + ks[(step + 1) % 3] & _M32
        x1 = x1 + ks[(step + 2) % 3] + (step + 1) & _M32
    return x0 ^ x1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """23 mantissa bits under the exponent of 1.0, minus 1: [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def uniform_plain(bits, lo: float, span: float) -> torch.Tensor:
    """max(lo, floats * span + lo), the multiply-add contracted."""
    return torch.clamp(_fma_t(_unit_floats(bits), span, lo), min=lo)


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (the two polynomials of `_ERFINV_LT` and
    `_ERFINV_GT`) in torch ops."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = np.float32

    def coef(i):
        return torch.where(lt, float(f32(_ERFINV_LT[i])),
                           float(f32(_ERFINV_GT[i])))

    p = coef(0)
    for i in range(1, 9):
        p = _fma_t(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float('inf'), p * x)


def threefry_normal(keys: torch.Tensor, n: int, scale: float = 1.0
                    ) -> torch.Tensor:
    """(K, 2) int64 key words (uint32 values) on a device -> (K, n)
    float32 scale * erf_inv(u) there, u the uniform of `normal`."""
    bits = threefry_bits_plain(keys, n)
    u = uniform_plain(bits, float(NORMAL_LO), float(NORMAL_SPAN))
    return scale * erf_inv_plain(u)


def _key_tensor(keys, device) -> torch.Tensor:
    return to_device(key_data(keys).reshape(-1, 2).astype(np.int64), device)


def draw_erf_inv(keys, n: int, device, scale=1.0) -> torch.Tensor:
    """f32(scale) * erf_inv(u) for each key, u the uniform of `normal`:
    `normal(key, (n,)) * c` as XLA evaluates it, for scale = f32(sqrt(2))
    * f32(c) (it folds the two constant factors), or the bare erf_inv for
    scale 1."""
    keys = key_data(keys)
    return threefry_normal(_key_tensor(keys, device), n,
                           scale=float(np.float32(scale))).reshape(
        keys.shape[:-1] + (n,))


def draw_normal(keys, n: int, device, factor=None) -> torch.Tensor:
    """`normal(key, (n,))` for each key, on `device`; with a constant
    `factor`, `normal(key, (n,)) * factor` as XLA folds it."""
    scale = _SQRT2 if factor is None else _SQRT2 * np.float32(factor)
    return draw_erf_inv(keys, n, device, scale)
