"""threefry2x32 key operations in numpy, bit-equal to `jax.random`.

The eval harness seeds each image's noise kernel from
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
  and k-means init.

A key is a `(2,)` uint32 array, as `jax.random.PRNGKey` returns.  Every
function also takes a batch of keys, (..., 2), and returns one result per
key along the leading axes, as `jax.vmap` over the keys would.
"""

from __future__ import annotations

import numpy as np

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
