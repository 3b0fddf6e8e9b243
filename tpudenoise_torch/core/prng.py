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
  the span with jax's multiplier trick, in wrapping uint32 arithmetic.

A key is a `(2,)` uint32 array, as `jax.random.PRNGKey` returns.
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


def fold_in(key, data: int) -> np.ndarray:
    key = key_data(key)
    b1, b2 = threefry2x32(key[0], key[1], _U32(0),
                          _U32(int(data) & 0xFFFFFFFF))
    return np.asarray([b1, b2], _U32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` -> (num, 2) uint32."""
    key = key_data(key)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(num, _U32),
                          np.arange(num, dtype=_U32))
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32-bit draws of `shape` (`jax.random.bits` for uint32)."""
    key = key_data(key)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 output
    and int32-range bounds."""
    if not -2**31 <= minval and maxval <= 2**31 - 1:
        raise ValueError('bounds outside the int32 range')
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    span = np.uint64((maxval - minval) & 0xFFFFFFFF if maxval > minval
                     else 1)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult) & mask
    mult = mult % span
    off = (((higher % span) * mult) & mask) + (lower % span)
    off = (off & mask) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
