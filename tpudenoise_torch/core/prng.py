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
  and k-means init; `normal` is `_normal_real`: sqrt(2) * erf_inv of a
  uniform in [nextafter(-1, 0), 1).
* `draw_bits`, `draw_uniform` and `draw_normal` take the same draws for
  B keys x N elements on a torch device (the threefry kernel on a GPU);
* `fold_in_path` derives a flax module's rng (the dropout keys);
* `hash_draw` takes the counter-hash stream of `--fast-rng`
  (`tpudenoise/noise/fast_samplers.py:62-104`) for B seed pairs x N
  elements on a torch device (the hash-stream kernel on a GPU).

A key is a `(2,)` uint32 array, as `jax.random.PRNGKey` returns.  Every
function also takes a batch of keys, (..., 2), and returns one result per
key along the leading axes, as `jax.vmap` over the keys would.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch import cuda_build
from tpudenoise_torch.utils.transfer import to_device

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


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv: w = -log1p(-x*x), then a degree-8 Horner in w - 2.5
    or sqrt(w) - 3 with each step an FMA, as XLA's CPU code contracts it.
    XLA's log1p is not correctly rounded, so the result agrees with jax to
    a few ulps (bit-equal on ~99% of normal draws)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -np.log1p(-(x * x))
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT[0]), f32(_ERFINV_GT[0])).astype(f32)
    for lo_c, hi_c in zip(_ERFINV_LT[1:], _ERFINV_GT[1:]):
        p = _fma32(p, w, np.where(lt, f32(lo_c), f32(hi_c)))
    return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)


def normal(key, shape) -> np.ndarray:
    """`jax.random.normal` for float32 (`_normal_real`): sqrt(2) *
    erf_inv(u), u uniform in [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, NORMAL_LO, 1.0)
    return (_SQRT2 * _erf_inv32(u)).astype(np.float32)


# --------------------------------------------------------- device draws --
#
# The noise generators draw whole fields: B keys x N elements (N = H*W*3,
# 1.8M per 600x1000 image).  On the host that takes seconds per chunk, so
# the draws run on the images' device: for a CUDA device the threefry
# kernel of `csrc/threefry.cu`, for the CPU its plain torch version below
# (the same arithmetic in int64 masked to 32 bits: torch on the CPU lacks
# uint32 `>>`).  Element i of key b is threefry2x32(key_b, (hi, lo) of i),
# then bits_hi ^ bits_lo, as `random_bits`.

_M32 = 0xFFFFFFFF
MODES = {'bits': 0, 'uniform': 1, 'normal': 2}

# kernel launches, counted where the wrapper launches the kernel
launches = {'threefry': 0, 'hash': 0}


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
    """`_erf_inv32` in torch f32 ops."""
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


def threefry_draw_plain(keys: torch.Tensor, n: int, mode: str,
                        lo: float = 0.0, span: float = 1.0,
                        scale: float = 1.0) -> torch.Tensor:
    """The plain version of the threefry kernel: (K, 2) int64 keys ->
    (K, n) int32 bits, or float32 uniforms / scale * erf_inv(u)."""
    bits = threefry_bits_plain(keys, n)
    if mode == 'bits':
        return (bits - ((bits >> 31) << 32)).to(torch.int32)
    if mode == 'uniform':
        return uniform_plain(bits, lo, span)
    u = uniform_plain(bits, float(NORMAL_LO), float(NORMAL_SPAN))
    return scale * erf_inv_plain(u)


def threefry_draw(keys: torch.Tensor, n: int, mode: str, lo: float = 0.0,
                  span: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """(K, 2) int64 key words (uint32 values) on a device -> (K, n) draws
    there: 'bits' int32, 'uniform' max(lo, u * span + lo), 'normal'
    scale * erf_inv(u) (float32; lo and span are then those of `normal`)."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError('keys must be (K, 2) int64')
    if not 0 < n < 2**31:
        raise ValueError(f'n = {n} outside [1, 2**31)')
    if keys.device.type == 'cpu':
        return threefry_draw_plain(keys, n, mode, lo, span, scale)
    if keys.device.type != 'cuda':
        raise ValueError(f'unsupported device {keys.device}')
    k = keys.shape[0]
    if mode == 'normal':          # the uniform of `normal`, whatever given
        lo, span = NORMAL_LO, NORMAL_SPAN
    words = (keys & _M32).to(torch.int32).contiguous()   # wraps to int32
    dtype = torch.int32 if mode == 'bits' else torch.float32
    out = torch.empty((k, n), dtype=dtype, device=keys.device)
    cuda_build.launch('threefry', 'threefry_draw', words, out, k, n,
                      MODES[mode], float(lo), float(span), float(scale))
    launches['threefry'] += 1
    return out


def _key_tensor(keys, device) -> torch.Tensor:
    return to_device(key_data(keys).reshape(-1, 2).astype(np.int64), device)


def draw_bits(keys, n: int, device) -> torch.Tensor:
    """`random_bits(key, (n,))` for each key of (..., 2) as int32 (the
    same 32 bits) on `device`: (..., n)."""
    keys = key_data(keys)
    return threefry_draw(_key_tensor(keys, device), n, 'bits').reshape(
        keys.shape[:-1] + (n,))


def draw_uniform(keys, n: int, device, minval=0.0,
                 maxval=1.0) -> torch.Tensor:
    """`uniform(key, (n,), minval, maxval)` for each key, on `device`."""
    keys = key_data(keys)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return threefry_draw(_key_tensor(keys, device), n, 'uniform', float(lo),
                         float(span)).reshape(keys.shape[:-1] + (n,))


def draw_erf_inv(keys, n: int, device, scale=1.0) -> torch.Tensor:
    """f32(scale) * erf_inv(u) for each key, u the uniform of `normal`:
    `normal(key, (n,)) * c` as XLA evaluates it, for scale = f32(sqrt(2))
    * f32(c) (it folds the two constant factors), or the bare erf_inv for
    scale 1."""
    keys = key_data(keys)
    return threefry_draw(_key_tensor(keys, device), n, 'normal',
                         scale=float(np.float32(scale))).reshape(
        keys.shape[:-1] + (n,))


def draw_normal(keys, n: int, device, factor=None) -> torch.Tensor:
    """`normal(key, (n,))` for each key, on `device`; with a constant
    `factor`, `normal(key, (n,)) * factor` as XLA folds it."""
    scale = _SQRT2 if factor is None else _SQRT2 * np.float32(factor)
    return draw_erf_inv(keys, n, device, scale)


def fold_in_path(key, path) -> np.ndarray:
    """flax's `_fold_in_static` (its `make_rng` keys): fold the first 4
    bytes (big-endian) of the SHA-1 of `path` into the key, each str as
    UTF-8 and each int as its minimal big-endian bytes, with no separator
    (flax_fix_rng_separator is off).  A dropout layer's key is
    fold_in_path(rng, (*module path, 1)) for its first draw."""
    import hashlib
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode('utf-8'))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, 'big'))
    return fold_in(key, int.from_bytes(m.digest()[:4], 'big'))


# ------------------------------------------------------ counter hash --
#
# `--fast-rng` swaps the generators' threefry draws for a splitmix-style
# u32 hash of (flat counter, salt, 64-bit seed) (`fast_samplers.py:62-104`):
# the counter is each image's flat element index over its own shape, as
# under the reference's vmap, and the seed pair is the image's key words
# [0] and [-1] (`_seed_from_key`), which for a threefry key is the key.
# The plain version does the u32 arithmetic in int64 masked to 32 bits;
# it serves the CPU and the tests.

HASH_MODES = {'bits': 0, 'u01': 1, 'normal': 2}
_TWO_PI = float(np.float32(2.0 * np.pi))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for a < 2^32 (int64) and a u32 constant c, in two
    16-bit halves of c so that no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_words_plain(seeds: torch.Tensor, n: int, salt: int
                     ) -> torch.Tensor:
    """`_hash_words((n,), salt, seed)` for each (K, 2) int64 seed pair:
    (K, n) int64 u32 words."""
    s0, s1 = seeds[:, :1] & _M32, seeds[:, 1:] & _M32
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)[None]
    h = (_mul32(idx, 0x9E3779B9) ^ ((salt * 0x85EBCA6B) & _M32)
         ^ _mul32(s0, 0xC2B2AE35))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ _mul32(s1, 0x27D4EB2F)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _u01_plain(words: torch.Tensor) -> torch.Tensor:
    """`_u01`: the top 24 bits as f32, plus half an ulp, times 2^-24."""
    return ((words >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def hash_draw_plain(seeds: torch.Tensor, n: int, salt: int, mode: str
                    ) -> torch.Tensor:
    """The plain version of the hash-stream kernel: (K, 2) int64 seed
    pairs -> (K, n) int32 words ('bits'), f32 uniforms in (0, 1) ('u01')
    or Box-Muller normals of salts salt and salt + 1 ('normal')."""
    words = hash_words_plain(seeds, n, salt)
    if mode == 'bits':
        return (words - ((words >> 31) << 32)).to(torch.int32)
    u1 = _u01_plain(words)
    if mode == 'u01':
        return u1
    u2 = _u01_plain(hash_words_plain(seeds, n, salt + 1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def hash_draw(seeds: torch.Tensor, n: int, salt: int, mode: str
              ) -> torch.Tensor:
    """(K, 2) int64 seed pairs (uint32 values) on a device -> (K, n) draws
    of the counter hash there, modes as `hash_draw_plain`."""
    if seeds.dim() != 2 or seeds.shape[1] != 2 or seeds.dtype != torch.int64:
        raise ValueError('seeds must be (K, 2) int64')
    if not 0 < n < 2**31:
        raise ValueError(f'n = {n} outside [1, 2**31)')
    if not 0 <= salt < 2**31 - 1:
        raise ValueError(f'salt {salt} outside [0, 2**31 - 1)')
    if seeds.device.type == 'cpu':
        return hash_draw_plain(seeds, n, salt, mode)
    if seeds.device.type != 'cuda':
        raise ValueError(f'unsupported device {seeds.device}')
    words = (seeds & _M32).to(torch.int32).contiguous()
    dtype = torch.int32 if mode == 'bits' else torch.float32
    out = torch.empty((seeds.shape[0], n), dtype=dtype, device=seeds.device)
    cuda_build.launch('hash_stream', 'hash_draw', words, out,
                      seeds.shape[0], n, salt, HASH_MODES[mode])
    launches['hash'] += 1
    return out


def seed_from_key(keys) -> np.ndarray:
    """`_seed_from_key` for each key of (..., 2): the words [0] and [-1]
    of the key data."""
    keys = key_data(keys)
    return keys[..., [0, -1]]


def draw_hash(keys, n: int, salt: int, mode: str, device) -> torch.Tensor:
    """The counter-hash draw of `mode` seeded from each key of (..., 2),
    on `device`: (..., n)."""
    seeds = seed_from_key(keys)
    return hash_draw(_key_tensor(seeds, device), n, salt, mode).reshape(
        seeds.shape[:-1] + (n,))
