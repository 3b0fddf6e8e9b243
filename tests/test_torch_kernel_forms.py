"""The identities that the CUDA forms of kernels 1 and 2 (sap + median,
gaussian + blur, `csrc/fused_noise.cu`), kernel 6 (mixed noise,
`csrc/mix_noise.cu`) and kernels 9-11 (`csrc/sap_stages.cu`) rest on,
checked on the CPU in the kernels' operation order.

* Kernel 1's packed route: a lane at two rows in one 32-bit word (u16x2)
  sorted by three-input per-half min/max, mid = a + b + c - lo - hi and
  med3 by the same identity, over every u8 triple in one half with other
  triples in the other; the merge of three sorted columns equals the
  median of the nine values (packed and float forms; random, saturated
  and all-equal sets); the row hash from a lane's fixed term is hash2d.
* Kernel 2's integer route: on integers in [0, 255] the reference's float
  blur equals s = a + 2b + c per column and (s_L + 2 s_V + s_R + 8) >> 4
  (every vertical tap; the horizontal step and its rounding on 10^7
  random column sums, the edges 0 and 1020 and every tie at x.5).
* Kernel 2's walk: a numpy model of the kernel's loop (a lane a thread,
  windows of `threads` lanes, segments of rows walked 8 rows a step, rows
  -1 and h of the first pass taken in reversed order on the float route)
  equals the plain version bit for bit on both routes.
* Kernels 9-11's walk: a numpy model of the stage kernels' loop on a
  pre-padded raster (a lane a thread, windows of 24 and 40 lanes,
  segments over hp walked in pairs of rows, raster rows unclamped and
  hash rows clamped, re-pad of filtered rows -1 and h only, pad lanes
  covered; u8 packed, f32 packed until a step's values fail the integer
  test and on the float walk from there) equals sap_stages_plain bit for
  bit for med1 and full.
* Kernel 6's samplers: torch models of the early-exit forms (the inverse
  CDF leaves once u <= cdf, PTRS stops at its first accepted round and
  draws the fallback only where none accepted, gamma stops at its first
  accepted round), each computing only what the kernel computes, equal
  bit for bit to the plain version's full loops over ~10^6 hashed
  elements a kind, lam around 10 and images with few distinct values
  among them.
"""

import functools

import numpy as np
import pytest
import torch

from tpudenoise_torch.noise import fused_kernels as fk
from tpudenoise_torch.noise import mix_kernels as mk
from tpudenoise_torch.noise.generators import wrap_cast_u8

F = np.float32


# ------------------------------------------------- kernel 2: the blur ----

def _vtap_f(a, b, c):
    return (F(0.25) * a + F(0.5) * b) + F(0.25) * c


def _htap_f(l, v, r):
    return np.floor(((F(0.25) * l + F(0.5) * v) + F(0.25) * r) + F(0.5))


def test_vertical_tap_is_exact_on_u8_values():
    """(0.25a + 0.5b) + 0.25c in f32 is (a + 2b + c) / 4 for every a, b, c
    in [0, 255]."""
    b, c = np.meshgrid(np.arange(256, dtype=F), np.arange(256, dtype=F),
                       indexing='ij')
    s_bc = 2 * b.astype(np.int64) + c.astype(np.int64)
    for a in range(256):
        got = _vtap_f(F(a), b, c)
        assert got.dtype == F
        np.testing.assert_array_equal(got * F(4), (a + s_bc).astype(F))


def _column_sums(rng, n):
    s = rng.randint(0, 1021, (3, n))
    edges = np.array([[0, 0, 0], [1020, 1020, 1020], [0, 1020, 0],
                      [1020, 0, 1020], [1, 0, 0], [0, 0, 1]]).T
    # ties: totals at 16k + 8, whose float form lands on x.5 exactly
    tl, tv = rng.randint(0, 1021, (2, n // 4))
    tr = 16 * rng.randint(0, 256, n // 4) + 8 - tl - 2 * tv
    ok = (tr >= 0) & (tr <= 1020)
    ties = np.stack([tl[ok], tv[ok], tr[ok]])
    return np.concatenate([s, edges, ties], 1)


def test_horizontal_tap_and_round_are_exact():
    """floor(((0.25 L + 0.5 V) + 0.25 R) + 0.5) on vertical taps s/4
    equals (s_L + 2 s_V + s_R + 8) >> 4, ties at x.5 rounding up."""
    rng = np.random.RandomState(0)
    sl, sv, sr = _column_sums(rng, 10_000_000)
    assert ((sl + 2 * sv + sr) % 16 == 8).sum() > 1_000_000
    got = _htap_f(sl.astype(F) / F(4), sv.astype(F) / F(4),
                  sr.astype(F) / F(4))
    want = (sl + 2 * sv + sr + 8) >> 4
    assert want.max() == 255 and want.min() == 0
    np.testing.assert_array_equal(got, want.astype(F))


def _reflect_row(y, h):
    y = -y if y < 0 else y
    y = 2 * (h - 1) - y if y > h - 1 else y
    return -y if y < 0 else y


BATCH = 8   # rows a step (fused_noise.cu kBatch)


def _walk(x, threads, seg_rows, double, exact):
    """Kernel 2's loop over one raster x (h, w3) of noisy values (int64 on
    the integer route, float32 on the float one), vectorised over the
    threads of a block."""
    h, w3 = x.shape
    vtap = (lambda a, b, c: a + 2 * b + c) if exact else _vtap_f
    htap = ((lambda l, v, r: (l + 2 * v + r + 8) >> 4) if exact
            else _htap_f)
    out = np.full((h, w3), -1, x.dtype)
    t = np.arange(threads)
    out_w = threads - 12
    for c0 in range(0, w3, out_w):
        lane = c0 - 6 + t
        live = (lane >= 0) & (lane < w3)
        mid = live & (t >= 3) & (t < threads - 3)
        outl = live & (t >= 6) & (t < threads - 6)
        tl = np.where(~mid, t, np.where(lane >= 3, t - 3, t + 3))
        tr = np.where(~mid, t, np.where(lane < w3 - 3, t + 3, tl))
        for r0 in range(0, h, seg_rows):
            r1 = min(r0 + seg_rows, h)
            first, last = r0 - (2 if double else 1), r1 + (1 if double else 0)
            n0 = n1 = m0 = m1 = np.zeros(threads, x.dtype)
            for j0 in range(first, last + 1, BATCH):
                tap1 = []
                for k in range(BATCH):
                    j = j0 + k
                    n = np.zeros(threads, x.dtype)
                    if j <= last:
                        n = np.where(live, x[_reflect_row(j, h),
                                             np.clip(lane, 0, w3 - 1)], 0)
                    rev = not exact and j - 1 in (-1, h)
                    tap1.append(vtap(n, n1, n0) if rev else vtap(n0, n1, n))
                    n0, n1 = n1, n
                tap2 = []
                for k in range(BATCH):
                    m = htap(tap1[k][tl], tap1[k], tap1[k][tr])
                    o = j0 + k - 1
                    if double:
                        tap2.append(vtap(m0, m1, m))
                        m0, m1 = m1, m
                    elif r0 <= o < r1:
                        out[o, lane[outl]] = m[outl]
                for k, tap in enumerate(tap2):
                    o = j0 + k - 2
                    if r0 <= o < r1:
                        out[o, lane[outl]] = htap(tap[tl], tap, tap[tr])[outl]
    return out


WALK_SHAPES = [(2, 2), (2, 7), (3, 5), (13, 11), (37, 29)]


@pytest.mark.parametrize('route', ['u8 + noise', 'u8', 'f32 non-integers',
                                   'f32 wide range'])
@pytest.mark.parametrize('double', [True, False])
def test_blur_walk_matches_plain(route, double):
    """The walk (strips of 4 and 12 output lanes, segments of 8 rows and
    of the whole height) equals fused_gaussian_blur_plain bit for bit: the
    integer route on the noisy u8 values, the float route on f32 values
    that are not integers, and on values from 1e-2 to 1e9 of both signs,
    whose first-pass rows -1 and h take other bits in the other tap
    order."""
    for h, w in WALK_SHAPES:
        rng = np.random.RandomState(h * w)
        im = rng.randint(0, 256, (2, h, w, 3)).astype(F)
        seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, 2)
                                 .astype(np.int32))
        var = 0.1 if route == 'u8 + noise' else 0.0
        x = torch.from_numpy(im.reshape(2, h, 3 * w))
        if route == 'f32 non-integers':
            im = im + rng.uniform(-0.5, 0.5, im.shape).astype(F)
            x = torch.from_numpy(im.reshape(2, h, 3 * w))
        elif route == 'f32 wide range':   # tap order shows in the output
            im = (rng.choice([-1, 1], im.shape)
                  * 10.0 ** rng.uniform(-2, 9, im.shape)).astype(F)
            x = torch.from_numpy(im.reshape(2, h, 3 * w))
        elif var:
            iy, ix, seed = fk._coords(h, 3 * w, seeds)
            z = fk._gauss_noise(iy, ix, seed, torch.full(
                (2, 1, 1), float(np.sqrt(var)), dtype=torch.float32))
            x = torch.trunc(torch.clamp(x * fk._INV255 + z, 0.0, 1.0) * 255.0)
        images = torch.from_numpy(im)
        exact = not route.startswith('f32')
        if exact:
            images = images.to(torch.uint8)
        want = fk.fused_gaussian_blur_plain(images, seeds, var, double)
        want = want.reshape(2, h, 3 * w).numpy().astype(F)
        vals = x.numpy().astype(np.int64 if exact else F)
        for threads in (16, 24):
            for seg_rows in (8, h):
                for i in range(2):
                    got = _walk(vals[i], threads, seg_rows, double, exact)
                    np.testing.assert_array_equal(
                        got.astype(F), want[i],
                        err_msg=f'{(h, w)} threads {threads} rows {seg_rows}')


# ------------------------------------ kernel 1: sorted columns, packed --

U32 = np.uint32


def _pack(top, bot):
    """A lane at two rows in one word, as PackedMedian::pack: row j in
    bits 0-15, row j + 1 in bits 16-31."""
    return (np.asarray(top, U32) | (np.asarray(bot, U32) << U32(16)))


def _halves(w):
    return w & U32(0xFFFF), w >> U32(16)


def _per_half(fn, *ws):
    """A DPX u16x2 operation: fn on each 16-bit half on its own."""
    tops, bots = zip(*(_halves(w) for w in ws))
    return _pack(fn(*tops), fn(*bots))


def _vimin3(a, b, c):
    return _per_half(lambda *v: np.minimum(np.minimum(v[0], v[1]), v[2]),
                     a, b, c)


def _vimax3(a, b, c):
    return _per_half(lambda *v: np.maximum(np.maximum(v[0], v[1]), v[2]),
                     a, b, c)


def _sort3_packed(a, b, c):
    """PackedMedian::sort3 in 32-bit wraparound arithmetic."""
    lo, hi = _vimin3(a, b, c), _vimax3(a, b, c)
    return lo, a + b + c - lo - hi, hi


def _med3_packed(a, b, c):
    return a + b + c - _vimax3(a, b, c) - _vimin3(a, b, c)


def _merge_packed(cols):
    (lo_l, mid_l, hi_l), (lo_c, mid_c, hi_c), (lo_r, mid_r, hi_r) = cols
    return _med3_packed(_vimax3(lo_l, lo_c, lo_r),
                        _med3_packed(mid_l, mid_c, mid_r),
                        _vimin3(hi_l, hi_c, hi_r))


def _sort3_f(a, b, c):
    """sap::sort3 (sap_median.cuh) in its operation order."""
    lo, hi = np.fmin(a, b), np.fmax(a, b)
    m = np.fmin(hi, c)
    return np.fmin(lo, m), np.fmax(lo, m), np.fmax(hi, c)


def _med3_f(a, b, c):
    return np.fmax(np.fmin(a, b), np.fmin(np.fmax(a, b), c))


def _merge_f(cols):
    """The merge of fused_noise.cu (median9's last step): max3, min3 and
    med3 in median9's order."""
    (lo_l, mid_l, hi_l), (lo_c, mid_c, hi_c), (lo_r, mid_r, hi_r) = cols
    return _med3_f(np.fmax(np.fmax(lo_l, lo_c), lo_r),
                   _med3_f(mid_l, mid_c, mid_r),
                   np.fmin(np.fmin(hi_l, hi_c), hi_r))


def test_packed_sort3_and_med3_are_exact_on_every_u8_triple():
    """Over all 256^3 triples (a, b, c) in the rows-j halves, with other
    triples in the rows-(j + 1) halves: vimin3/vimax3 give each half's
    min and max, mid = a + b + c - lo - hi in 32-bit wraparound arithmetic
    gives each half's median (nothing carries or borrows across the
    halves), and med3 by the same identity equals the float med3 form of
    sap::med3 on each half."""
    b, c = np.meshgrid(np.arange(256, dtype=U32), np.arange(256, dtype=U32),
                       indexing='ij')
    b, c = b.ravel(), c.ravel()
    for a in range(256):
        a_ = np.full_like(b, a)
        tops = (a_, b, c)
        bots = (c, U32(255) - b, (a_ + b * U32(7)) % U32(256))
        words = [_pack(t, u) for t, u in zip(tops, bots)]
        lo, mid, hi = _sort3_packed(*words)
        med = _med3_packed(*words)
        for half, vals in ((0, tops), (1, bots)):
            want = np.sort(np.stack(vals), 0)
            for got, k in ((lo, 0), (mid, 1), (hi, 2)):
                np.testing.assert_array_equal(_halves(got)[half], want[k])
            np.testing.assert_array_equal(
                _halves(med)[half],
                _med3_f(*(v.astype(F) for v in vals)).astype(U32))


def _nine(kind, rng):
    """(n, 3, 3) sets of nine values: [row, column]."""
    if kind == 'random':
        return rng.randint(0, 256, (200_000, 3, 3))
    if kind == 'saturated':   # every set of nine 0s and 255s
        bits = (np.arange(512)[:, None] >> np.arange(9)) & 1
        return (255 * bits).reshape(512, 3, 3)
    return np.repeat(np.arange(256), 9).reshape(256, 3, 3)   # all equal


@pytest.mark.parametrize('kind', ['random', 'saturated', 'all equal'])
@pytest.mark.parametrize('route', ['packed', 'float'])
def test_merge_of_sorted_columns_is_the_median_of_nine(kind, route):
    """Each column sorted once (rows y-1, y, y+1), then the merge of the
    three sorted columns (max of the los, med3 of the mids, min of the
    his) equals the median of the nine values: the packed route on u8
    values in both halves at once (the second half holds other sets), the
    float route on the same values and on non-integers."""
    rng = np.random.RandomState(len(kind))
    sets = _nine(kind, rng)
    want = np.sort(sets.reshape(len(sets), 9), 1)[:, 4]
    if route == 'packed':
        other = sets[rng.permutation(len(sets))][:, ::-1]
        words = _pack(sets, other)
        cols = [_sort3_packed(*words[:, :, x].T) for x in range(3)]
        got = _merge_packed(cols)
        np.testing.assert_array_equal(_halves(got)[0], want)
        np.testing.assert_array_equal(
            _halves(got)[1],
            np.sort(other.reshape(len(sets), 9), 1)[:, 4])
        return
    for vals in (sets.astype(F),
                 sets.astype(F) + rng.uniform(-0.5, 0.5, sets.shape)
                 .astype(F)):
        cols = [_sort3_f(*vals[:, :, x].T) for x in range(3)]
        np.testing.assert_array_equal(
            _merge_f(cols), np.sort(vals.reshape(len(vals), 9), 1)[:, 4])


def test_row_hash_from_lane_term_is_hash2d():
    """sap::hash2d_row(iy, hash2d_lane(ix, seed)) == hash2d(iy, ix, seed):
    the lane and seed terms are taken once for a lane."""
    rng = np.random.RandomState(1)
    iy, ix, seed = (rng.randint(0, 2**32, 100_000, dtype=np.uint64)
                    .astype(U32) for _ in range(3))
    with np.errstate(over='ignore'):
        h = (iy * U32(0x9E3779B9)) ^ ((ix * U32(0x85EBCA6B))
                                      ^ (seed * U32(0xC2B2AE35)))
        h ^= h >> U32(16)
        h *= U32(0x7FEB352D)
        h ^= h >> U32(15)
        h *= U32(0x846CA68B)
        h ^= h >> U32(16)
    want = fk.hash2d(*(torch.from_numpy(v.astype(np.int64))
                       for v in (iy, ix, seed)))
    np.testing.assert_array_equal(h.astype(np.int64), want.numpy())


# ------------------------- kernels 9-11: the walk on a pre-padded raster --

class _PackedRoute:
    """PackedMedian on numpy: a lane at rows j (bits 0-15) and j + 1
    (16-31) of a pair in one uint32."""
    pairs = 4

    @staticmethod
    def pack(top, bot):
        return _pack(top.astype(U32), bot.astype(U32))

    @staticmethod
    def join(a, c):   # __byte_perm(a, c, 0x5432)
        return (a >> U32(16)) | (c << U32(16))

    sort3 = staticmethod(_sort3_packed)

    @staticmethod
    def merge(taps, tl, tr):
        return _merge_packed([tuple(v[i] for v in taps)
                              for i in (tl, slice(None), tr)])

    @staticmethod
    def both_bot(m):
        return _pack(*(2 * [m >> U32(16)]))

    @staticmethod
    def both_top(m):
        return _pack(*(2 * [m & U32(0xFFFF)]))

    @staticmethod
    def top_from(m, prev):
        return _pack(prev >> U32(16), m >> U32(16))

    @staticmethod
    def rows(v):
        return _halves(v)

    @staticmethod
    def to_float(v):   # the carried rows of a block leaving the route
        return np.stack(_halves(v)).astype(F)


class _FloatRoute:
    """FloatMedian on numpy: a pair as a (2, lanes) float32 array."""
    pairs = 2
    pack = staticmethod(lambda top, bot: np.stack([top, bot]).astype(F))
    join = staticmethod(lambda a, c: np.stack([a[1], c[0]]))
    sort3 = staticmethod(_sort3_f)

    @staticmethod
    def merge(taps, tl, tr):
        return _merge_f([tuple(v[:, i] for v in taps)
                         for i in (tl, slice(None), tr)])

    both_bot = staticmethod(lambda m: np.stack([m[1], m[1]]))
    both_top = staticmethod(lambda m: np.stack([m[0], m[0]]))
    top_from = staticmethod(lambda m, prev: np.stack([prev[1], m[1]]))
    rows = staticmethod(lambda v: (v[0], v[1]))


def _integer_u8(v):
    """CheckedPacked's test: the bits of an integer in [0, 255] (not NaN,
    not -0.0)."""
    with np.errstate(invalid='ignore'):
        return ((v >= 0) & (v <= 255) & (np.trunc(v) == v)
                & ~((v == 0) & np.signbit(v)))


def _stage_walk(noisy, raw, h, w3, double, threads, seg_rows, route):
    """sap_stages_walk_kernel over one image's raster: noisy (hp + 8, w3p)
    float32 values after salt & pepper (raster row g + 4 holds global row
    g), raw the raster before it.  A block of `threads` lanes per strip
    and a segment of seg_rows output rows walks its rows in steps of
    pairs; route 'packed' (u8), 'checked' (f32: packed while every value
    a step loads passes `_integer_u8`, the float route from the first
    step where one does not) or 'float'.  Returns (hp, w3p) float32, and
    the number of blocks that left the packed route."""
    rows, w3p = noisy.shape
    hp = rows - 8
    out = np.full((hp, w3p), np.nan, F)
    t = np.arange(threads)
    out_w = threads - 12
    d = 2 if double else 1
    switched = 0
    for c0 in range(0, w3p, out_w):
        x = c0 - 6 + t
        mid = (t >= 3) & (t < threads - 3)
        tl = np.where(mid & (x >= 3), t - 3, t)
        tr = np.where(mid & (x < w3 - 3), t + 3, t)
        outl = (x >= 0) & (x < w3p) & (t >= 6) & (t < threads - 6)
        xc = np.clip(x, 0, w3p - 1)
        for r0 in range(0, hp, seg_rows):
            r1 = min(r0 + seg_rows, hp)
            R = _FloatRoute if route == 'float' else _PackedRoute
            z = np.zeros(threads, U32)
            a = mp = R.pack(z, z)
            j0 = r0 - d - (2 if double and r0 == h + 1 else 0)
            while j0 - d < r1:
                P = R.pairs
                edge = not (j0 - d >= r0 and j0 - d + 2 * P <= r1
                            and j0 + 2 * P <= h)
                a_in, bad, taps = a, False, []
                for k in range(P):
                    n = []
                    for j in (j0 + 2 * k, j0 + 2 * k + 1):
                        assert j >= -4 and (edge or 0 <= j < h)
                        y = min(j, hp + 3) + 4
                        v = noisy[y, xc]
                        if R is _PackedRoute:
                            bad |= not _integer_u8(raw[y, xc]).all()
                            v = np.where(_integer_u8(v), v, 0).astype(U32)
                        n.append(v)
                    c = R.pack(*n)
                    taps.append(R.sort3(a, R.join(a, c), c))
                    a = c
                if route == 'checked' and R is _PackedRoute and bad:
                    # redo the step on the float route, rows converted
                    switched += 1
                    a, mp = R.to_float(a_in), R.to_float(mp)
                    R = _FloatRoute
                    continue
                m = [R.merge(tp, tl, tr) for tp in taps]

                def put(o, v):
                    for row, val in zip((o, o + 1), R.rows(v)):
                        if not edge:
                            assert r0 <= row < r1
                        elif not r0 <= row < r1:
                            continue
                        out[row, x[outl]] = val[outl]

                if double:
                    if edge and (j0 <= 0 or j0 + 2 * P > h):
                        prev = mp
                        for k in range(P):
                            j = j0 + 2 * k
                            if j == 0:
                                m[k] = R.both_bot(m[k])
                            if j == h:
                                m[k] = R.both_top(m[k])
                            if j == h + 1:
                                m[k] = R.top_from(m[k], prev)
                            prev = m[k]
                    taps = []
                    for k in range(P):
                        taps.append(R.sort3(mp, R.join(mp, m[k]), m[k]))
                        mp = m[k]
                    for k in range(P):
                        put(j0 + 2 * k - 2, R.merge(taps[k], tl, tr))
                else:
                    for k in range(P):
                        put(j0 + 2 * k - 1, m[k])
                j0 += 2 * P
    assert not np.isnan(out).any()
    return out, switched


def _stage_noisy(raster, seed, h, w3):
    """The salt & pepper values of every raster row (float32), as
    sap_stages_plain draws them."""
    rows, w3p = raster.shape
    iy = torch.arange(-fk.HALO, rows - fk.HALO).clamp(0, h - 1)[:, None]
    ix = torch.arange(w3p).clamp(max=w3 - 1)[None]
    bits = fk.hash2d(iy, ix, torch.tensor(int(seed) & fk._M32)).numpy()
    flipped = bits < fk._sap_threshold(0.4)
    salted = (bits & 1) == 1
    noisy = np.where(flipped & salted, F(255), raster.astype(F))
    return np.where(flipped & ~salted, F(0), noisy).astype(F)


# (h, w, tile height): h <= 3 and odd, hp - h of several whole steps, w3 =
# 3 (125 pad lanes), w3p = 256
STAGE_CASES = {'h 1': (1, 5, 8), 'h 2': (2, 5, 8), 'h 3': (3, 5, 8),
               'h 13': (13, 5, 8), 'h 3, tile 56': (3, 5, 56),
               'w3 3': (7, 1, 8), 'w3 150': (9, 50, 8)}
STAGE_INPUTS = {'u8': 'packed', 'f32 integers': 'checked',
                'f32 non-integers': 'checked',
                'f32 leaving packed mid-walk': 'checked',
                'f32 float walk': 'float'}


@pytest.mark.parametrize('stage', ['med1', 'full'])
@pytest.mark.parametrize('inputs', list(STAGE_INPUTS))
@pytest.mark.parametrize('case', list(STAGE_CASES))
def test_stage_walk_matches_plain(case, inputs, stage):
    """The walk of kernels 9-11 (windows of 24 lanes for one image and 40
    for the other, segments of hp, 8, 3 and h + 1 rows walked in pairs)
    equals sap_stages_plain bit
    for bit, on the edge-padded raster and on a random one (halo rows and
    pad lanes random): u8 on the packed route; f32 integers packed to the
    end; f32 non-integers (with -0.0 and negatives) leaving the packed
    route at a segment's first step, or (a few rows of non-integers in
    the lower half) in mid-walk; f32 on the float walk alone."""
    from tpudenoise_torch.benchmarks.profile_sap_breakdown import pad_raster
    h, w, tile = STAGE_CASES[case]
    rng = np.random.RandomState(h * 100 + w + tile)
    im = rng.randint(0, 256, (2, h, w, 3))
    seeds = rng.randint(-2**31, 2**31 - 1, 2).astype(np.int32)
    edge = pad_raster(torch.from_numpy(im), tile).numpy()
    route = STAGE_INPUTS[inputs]
    switched = 0
    for raster in (edge, rng.randint(0, 256, edge.shape)):
        raster = raster.astype(F)
        hp = raster.shape[1] - 8
        if inputs in ('f32 non-integers', 'f32 float walk'):
            raster += rng.uniform(-0.5, 0.5, raster.shape).astype(F)
            raster[rng.rand(*raster.shape) < 0.05] = F(-0.0)
        elif inputs == 'f32 leaving packed mid-walk':
            rows = rng.randint(hp // 2 + 4, hp + 8, 2)
            raster[:, rows, ::17] += F(0.25)
        dtype = torch.uint8 if inputs == 'u8' else torch.float32
        r = torch.from_numpy(raster).to(dtype)
        want = fk.sap_stages_plain(r, torch.from_numpy(seeds), h, 3 * w,
                                   stage).numpy().astype(F)
        raw = r.numpy().astype(F)
        for i, threads in enumerate((24, 40)):
            noisy = _stage_noisy(raw[i], seeds[i], h, 3 * w)
            for seg in sorted({hp, 8, 3, h + 1} & set(range(1, hp + 1))):
                got, n = _stage_walk(noisy, raw[i], h, 3 * w,
                                     stage == 'full', threads, seg, route)
                switched += n
                np.testing.assert_array_equal(
                    got, want[i], err_msg=f'threads {threads} rows {seg}')
    assert (switched > 0) == (inputs in ('f32 non-integers',
                                         'f32 leaving packed mid-walk'))


# ----------------------------------------------- kernel 6: the samplers --

def _image(rng, h, w, values, level=0.0):
    """An mk._Image of u8 values drawn from `values`, vals as the
    prologue sets it (2^ceil(log2(distinct values)))."""
    x = rng.choice(np.asarray(values), (h, w, 3)).astype(F)
    vals = float(2.0 ** np.ceil(np.log2(len(np.unique(x)))))
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, 2)
                             .astype(np.int32))
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    return mk._Image(torch.from_numpy(x), f32(level), f32(vals), seeds,
                     torch.zeros(60), torch.zeros(48, 8))


def _draws(g, ctr):
    def u01(salt):
        return mk.u01_bits(mk.hash_ctr(ctr, salt, g.s0, g.s1))

    def normal(salt):
        u1, u2 = u01(salt), u01(salt + 1)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(mk._TWO_PI * u2)
    return u01, normal


def _cdf_k(u, lam, early):
    """The inverse CDF's k: the last n with u > cdf(n - 1) over 33 steps
    (the plain version's loop), or with early=True stopping each element
    at its first step with u <= cdf where lam >= 0 (poisson_small)."""
    lam_s = torch.clamp(lam, max=10.0)
    rising = lam_s >= 0.0
    prob = torch.exp(-lam_s)
    cdf = prob
    k = torch.zeros_like(lam_s)
    live = torch.ones_like(rising)
    for n in range(1, 34):
        up = u > cdf
        k = torch.where(live & up, float(n), k)
        if early:
            live = live & (up | ~rising)
        prob = torch.where(live, prob * lam_s * mk._f32(1.0 / n), prob)
        cdf = torch.where(live, cdf + prob, cdf)
    return k


def _poisson_early(g):
    """poisson_small / ptrs_round / poisson_fallback as the kernel runs
    them: each element only the sampler its lam selects, the CDF walk up
    to its deciding step, PTRS up to the first accepted round, the
    fallback only where no round accepted."""
    f32 = mk._f32
    lam = (g.x01 * g.vals).reshape(-1)
    ctr = g.ctr.reshape(-1)
    k = torch.full_like(lam, float('nan'))

    idx = torch.nonzero(lam < 10.0).squeeze(1)       # the inverse CDF
    u01, _ = _draws(g, ctr[idx])
    k[idx] = _cdf_k(u01(1), lam[idx], early=True)

    idx = torch.nonzero(~(lam < 10.0)).squeeze(1)    # PTRS
    lam_b = torch.clamp(lam[idx], min=10.0)
    b = f32(0.931) + f32(2.53) * torch.sqrt(lam_b)
    a = f32(-0.059) + f32(0.02483) * b
    inv_alpha = f32(1.1239) + f32(1.1328) / (b - f32(3.4))
    v_r = f32(0.9277) - f32(3.6224) / (b - 2.0)
    log_lam = torch.log(lam_b)
    pend = torch.arange(len(idx))
    for r in range(4):
        w = mk.hash_ctr(ctr[idx[pend]], 16 + r, g.s0, g.s1)
        uu = ((w >> 16).to(torch.float32) + 0.5) * f32(2.0 ** -16) - 0.5
        vv = ((w & 0xFFFF).to(torch.float32) + 0.5) * f32(2.0 ** -16)
        us = 0.5 - uu.abs()
        ap, bp, lp = a[pend], b[pend], lam_b[pend]
        cand = torch.floor((2.0 * ap / us + bp) * uu + lp + f32(0.43))
        acc = (us >= f32(0.07)) & (vv <= v_r[pend])
        slow = torch.nonzero(~acc & (cand >= 0.0) & (
            (us >= f32(0.013)) | (vv <= us))).squeeze(1)
        s_us, s_vv, s_c = us[slow], vv[slow], cand[slow]
        lhs = torch.log(s_vv * inv_alpha[pend][slow]
                        / (ap[slow] / (s_us * s_us) + bp[slow]))
        rhs = (-lp[slow] + s_c * log_lam[pend][slow]
               - mk._stirling_lgamma(s_c + 1.0))
        acc[slow] = lhs <= rhs
        k[idx[pend[acc]]] = cand[acc]
        pend = pend[~acc]
    _, normal = _draws(g, ctr[idx[pend]])
    lp = lam_b[pend]
    k[idx[pend]] = torch.clamp(torch.round(lp + torch.sqrt(lp) * normal(8)),
                               min=0.0)
    out = wrap_cast_u8(255.0 * torch.clamp(k / g.vals, 0.0, 1.0))
    return out.reshape(g.x.shape), len(pend)


def _gamma_early(g):
    """gamma_round as the kernel runs it: each element up to its first
    accepted round, `last` from the rounds that ran."""
    d, c = mk._GAMMA_D, mk._GAMMA_C
    ctr = g.ctr.reshape(-1)
    last = torch.full(ctr.shape, d, dtype=torch.float32)
    pend = torch.arange(len(ctr))
    for r in range(4):
        u01, normal = _draws(g, ctr[pend])
        x = normal(32 + 3 * r)
        u = u01(34 + 3 * r)
        t = 1.0 + c * x
        v = t * (t * t)
        pos = v > 0.0
        vs = torch.where(pos, v, 1.0)
        acc = pos & (torch.log(u) < 0.5 * x * x
                     + d * (1.0 - vs + torch.log(vs)))
        last[pend[pos]] = (d * vs)[pos]
        pend = pend[~acc]
    gam = last.reshape(g.x.shape)
    return wrap_cast_u8(255.0 * (g.x01 + gam * g.level)), len(pend)


POISSON_IMAGES = {
    'u8 values': range(256),                     # vals 256: ~4% below 10
    'lam around 10': range(0, 21),               # vals set to 256 below
    'dark band': list(range(0, 10)) * 20 + list(range(256)),
    'vals 4': (0, 80, 160, 255),                 # every lam below 4
    'vals 16': range(0, 256, 16),                # lam in [0, 15]
}


@pytest.mark.parametrize('name', sorted(POISSON_IMAGES))
def test_poisson_early_exit_matches_full_loops(name):
    """~2.5e5 elements an image, 1.25e6 in all."""
    g = _image(np.random.RandomState(len(name)), 250, 333,
               POISSON_IMAGES[name])
    if name == 'lam around 10':   # vals 256 with values around 10
        g.vals = torch.tensor(256.0)
    got, _ = _poisson_early(g)
    lam = g.x01 * g.vals
    print(f'{name}: vals {float(g.vals)}, lam < 10 on '
          f'{float((lam < 10).float().mean()):.3f}')
    assert torch.equal(got, mk._poisson(g))


def test_cdf_walk_stops_only_where_cdf_rises():
    """k of the early-exit walk equals the full walk's for lam in [0, 10)
    (cdf never falls) and for lam < 0 (no prologue gives it: vals >= 1),
    where prob changes sign, cdf can fall below u again, and the walk
    runs every step; the output map clips k / vals < 0 to 0, so only k
    shows it."""
    rng = np.random.RandomState(4)
    lam = np.concatenate([rng.uniform(0, 10, 200_000),
                          np.linspace(9.9, 10, 1000, dtype=F), [0.0, -0.0],
                          -rng.uniform(0, 12, 50_000)]).astype(F)
    u = mk.u01_bits(torch.from_numpy(rng.randint(0, 2**32, lam.size,
                                                 dtype=np.int64)))
    lam = torch.from_numpy(lam)
    full = _cdf_k(u, lam, early=False)
    assert (full[lam < 0] > 1).any()
    assert torch.equal(_cdf_k(u, lam, early=True), full)


@pytest.mark.parametrize('level', [0.2, 1.0])
def test_gamma_early_exit_matches_full_loops(level):
    """5e5 elements a level, 10^6 in all; some elements reach the fourth
    round."""
    g = _image(np.random.RandomState(int(level * 10)), 400, 417, range(256),
               level)
    got, left = _gamma_early(g)
    assert torch.equal(got, mk._gamma(g))
