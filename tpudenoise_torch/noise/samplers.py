"""Fixed-round Poisson and gamma samplers (counterpart of
`tpudenoise/noise/fast_samplers.py`: `poisson_fixed`, `gamma_fixed`,
`stirling_lgamma` and the counter-hash stream `_hash_words`, `_u01` and
`_normal`).

* `poisson_fixed`: CDF inversion (33 steps) for lam < 10, Hoermann's PTRS
  transformed rejection (4 fixed rounds, Stirling lgamma) above, and a
  rounded-normal fallback for lanes no round accepted.
* `gamma_fixed`: Marsaglia-Tsang squeeze, 4 fixed rounds, the last
  positive candidate for lanes no round accepted.

Every function is batched: one key per image, (B, 2) uint32, and fields
of (B, N) elements.  The key algebra runs on the host (`core.prng`); the
fields are drawn on the fields' device (`prng.draw_uniform` /
`draw_normal`, the threefry kernel on a GPU), in the reference's order:
poisson splits its key in three (inversion uniform, PTRS key, fallback
normal) and PTRS round r draws (u, v) from split(fold_in(key, r)); gamma
round r draws (x, u) from split(fold_in(key, r)).

`fast_bits=True` (`--fast-rng`) draws from the counter hash instead
(`prng.draw_hash`, the hash-stream kernel on a GPU), salts as the
reference's registry: poisson's inversion uniform 1, fallback normal 8
(and 9), PTRS round r one word of salt 16 + r (u in its high 16 bits, v
in its low 16); gamma round r a normal of salt 32 + 3r (and 33 + 3r) and
a uniform of 34 + 3r.

Where XLA's CPU code contracts a multiply feeding an add into one FMA,
the arithmetic here rounds once too (`prng._fma_t`, through float64); the
tests show which form matches.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudenoise_torch.core import prng
from tpudenoise_torch.core.prng import _fma_t

_SPLIT = 10.0     # lam cutoff between inverse-CDF and PTRS
_N_INV = 34       # inverse-CDF terms
_PTRS_ROUNDS = 4
_GAMMA_ROUNDS = 4
_F32 = np.float32


def _c(x: float) -> float:
    """A Python double rounded to f32, as the reference's weak-typed
    constants are."""
    return float(_F32(x))


def _hash_words(keys, n: int, salt: int, device) -> torch.Tensor:
    """(B, n) int32 words of the counter hash, one seed per key."""
    return prng.draw_hash(keys, n, salt, 'bits', device)


def _u01(keys, n: int, salt: int, device) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1) of the counter hash."""
    return prng.draw_hash(keys, n, salt, 'u01', device)


def _normal(keys, n: int, salt: int, device) -> torch.Tensor:
    """(B, n) Box-Muller normals of the hash's salts salt and salt + 1."""
    return prng.draw_hash(keys, n, salt, 'normal', device)


def stirling_lgamma(z: torch.Tensor) -> torch.Tensor:
    """lgamma(z) for z >= ~0.5: an 8-step recurrence lift, then
    (t - 1/2) ln t - t + ln(2 pi)/2 + 1/(12 t) - 1/(360 t^3)."""
    t = z + 8.0
    inv = 1.0 / t
    pr = z * inv
    for i in range(1, 8):
        pr = pr * ((z + float(i)) * inv)
    pr = torch.clamp(pr, min=_c(1e-30))
    inv2 = inv * inv
    series = inv * _fma_t(-inv2, _c(1.0 / 360.0), _c(1.0 / 12.0))
    head = _fma_t(t - 8.5, torch.log(t), -t)
    return ((head + _c(0.91893853320467274178)) + series) - torch.log(pr)


def _poisson_inv_cdf(u: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """k = min{n : sum_{i<=n} pmf(i) > u} by the recurrence
    p_k = p_{k-1} * lam / k from p_0 = exp(-lam)."""
    p = torch.exp(-lam)
    cdf = p
    k = torch.zeros_like(u)
    for n in range(1, _N_INV):
        k = torch.where(u > cdf, float(n), k)
        p = (p * lam) / float(n)
        cdf = cdf + p
    return k


def _ptrs_draws(key_ptrs, lam: torch.Tensor, fast_bits: bool):
    """Round r's (u, v) of PTRS: (u - 0.5, v) from split(fold_in(key,
    r)), all rounds in one threefry draw, or with fast_bits one hash word
    of salt 16 + r, u from its high 16 bits and v from its low 16."""
    n = lam.shape[1]
    if fast_bits:
        for r in range(_PTRS_ROUNDS):
            w = _hash_words(key_ptrs, n, 16 + r, lam.device)
            u = (((w >> 16) & 0xFFFF).to(torch.float32) + 0.5) * 2.0 ** -16
            v = ((w & 0xFFFF).to(torch.float32) + 0.5) * 2.0 ** -16
            yield u - 0.5, v
        return
    rk = prng.split(prng.fold_in(key_ptrs[:, None],
                                 np.arange(_PTRS_ROUNDS)[None]))
    draws = prng.draw_uniform(rk, n, lam.device)     # (B, R, 2, N)
    for r in range(_PTRS_ROUNDS):
        yield draws[:, r, 0] - 0.5, draws[:, r, 1]


def _poisson_ptrs(key_ptrs, lam: torch.Tensor, fast_bits: bool = False):
    """PTRS, _PTRS_ROUNDS fixed rounds over (B, N) lam >= 10; returns
    (k, ok)."""
    b = _fma_t(torch.sqrt(lam), _c(2.53), _c(0.931))
    a = _fma_t(b, _c(0.02483), _c(-0.059))
    inv_alpha = _c(1.1239) + _c(1.1328) / (b - _c(3.4))
    v_r = _c(0.9277) - _c(3.6224) / (b - 2.0)
    log_lam = torch.log(lam)
    k = torch.zeros_like(lam)
    ok = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    for u, v in _ptrs_draws(key_ptrs, lam, fast_bits):
        us = 0.5 - u.abs()
        cand = torch.floor(_fma_t((2.0 * a) / us + b, u, lam) + _c(0.43))
        accept = (us >= _c(0.07)) & (v <= v_r)
        safe = (cand >= 0.0) & ((us >= _c(0.013)) | (v <= us))
        lhs = torch.log((v * inv_alpha) / (a / (us * us) + b))
        rhs = _fma_t(cand, log_lam, -lam) - stirling_lgamma(cand + 1.0)
        accept = accept | (safe & (lhs <= rhs))
        k = torch.where(accept & ~ok, cand, k)
        ok = ok | accept
    return k, ok


def poisson_fixed(keys, lam: torch.Tensor,
                  fast_bits: bool = False) -> torch.Tensor:
    """Poisson(lam) counts as float32: keys (B, 2), lam (B, N) >= 0."""
    n = lam.shape[1]
    if fast_bits:
        keys = np.asarray(keys)
        u = _u01(keys, n, 1, lam.device)
        z = _normal(keys, n, 8, lam.device)
        k_ptrs = keys
    else:
        k_inv, k_ptrs, k_norm = np.moveaxis(prng.split(keys, 3), -2, 0)
        u = prng.draw_uniform(k_inv, n, lam.device)
        z = prng.draw_normal(k_norm, n, lam.device)
    small = lam < _SPLIT
    k_small = _poisson_inv_cdf(u, torch.clamp(lam, max=_SPLIT))
    lam_big = torch.clamp(lam, min=_SPLIT)
    k_big, ok = _poisson_ptrs(k_ptrs, lam_big, fast_bits)
    fallback = torch.clamp(torch.round(_fma_t(torch.sqrt(lam), z, lam)),
                           min=0.0)
    k_big = torch.where(ok, k_big, fallback)
    return torch.where(small, k_small, k_big)


def gamma_fixed(keys, a: float, n: int, device,
                fast_bits: bool = False) -> torch.Tensor:
    """Gamma(a, 1) draws, (B, n) float32, for a static shape a > 1,
    _GAMMA_ROUNDS fixed rounds."""
    if not a > 1.0:
        raise ValueError(f'gamma_fixed requires shape a > 1, got {a}')
    d = _F32(a - 1.0 / 3.0)
    c = float(_F32(1.0) / np.sqrt(_F32(9.0) * d))
    d = float(d)
    shape = (np.asarray(keys).shape[0], n)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    last = torch.full(shape, d, dtype=torch.float32, device=device)
    ok = torch.zeros(shape, dtype=torch.bool, device=device)
    for x, t, u in _gamma_draws(keys, c, n, device, fast_bits):
        v = t * (t * t)
        pos = v > 0.0
        vs = torch.where(pos, v, 1.0)
        rhs = _fma_t(0.5 * x, x, d * ((1.0 - vs) + torch.log(vs)))
        accept = pos & (torch.log(u) < rhs)
        cand = d * vs
        out = torch.where(accept & ~ok, cand, out)
        ok = ok | accept
        last = torch.where(pos, cand, last)
    return torch.where(ok, out, last)


def _gamma_draws(keys, c: float, n: int, device, fast_bits: bool):
    """Round r's normal x, t = 1 + c * x (one rounding) and uniform u:
    (x, u) from split(fold_in(key, r)), or with fast_bits x of the hash's
    salt 32 + 3r and u of 34 + 3r."""
    if fast_bits:
        keys = np.asarray(keys)
        for r in range(_GAMMA_ROUNDS):
            x = _normal(keys, n, 32 + 3 * r, device)
            yield x, _fma_t(x, c, 1.0), _u01(keys, n, 34 + 3 * r, device)
        return
    # round r: (kx, ku) = split(fold_in(key, r)): (B, R, 2, 2)
    rk = prng.split(prng.fold_in(np.asarray(keys)[:, None],
                                 np.arange(_GAMMA_ROUNDS)[None]))
    # XLA folds x's sqrt(2) into c: t = fma(erf_inv, c * sqrt(2), 1)
    e_all = prng.draw_erf_inv(rk[:, :, 0], n, device)
    u_all = prng.draw_uniform(rk[:, :, 1], n, device,
                              np.finfo(np.float32).tiny, 1.0)
    c_s2 = float(np.float32(c) * prng._SQRT2)
    for r in range(_GAMMA_ROUNDS):
        e = e_all[:, r]
        yield e * float(prng._SQRT2), _fma_t(e, c_s2, 1.0), u_all[:, r]
