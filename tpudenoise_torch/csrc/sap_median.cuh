// Device helpers of the salt & pepper + 3x3 median kernels, shared by
// fused_noise.cu (sap_median_*) and sap_stages.cu (the stage-cut profiling
// forks), so that their arithmetic cannot drift apart.
//
// Counterparts of tpudenoise/noise/pallas_kernels.py: _hash2d, _load_f32 /
// _store_row_block, _med3 and the column-sort form of _median3_tile
// (sort3, then merge).
// hash2d_lane / hash2d_row serve the row walks, which hash down one lane.
// Both files' walks (fused_noise.cu describes the walk) take their routes,
// taps, merge and segment plan from here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sap {

// the coordinate hash of _hash2d (splitmix-style avalanche)
__device__ __forceinline__ uint32_t hash2d(uint32_t iy, uint32_t ix,
                                           uint32_t seed) {
  uint32_t h = (iy * 0x9E3779B9u) ^ (ix * 0x85EBCA6Bu) ^ (seed * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// hash2d split for a walk down one lane: the lane and seed terms, fixed
// for the lane, once; then each row's hash from them.
// hash2d_row(iy, hash2d_lane(ix, seed)) == hash2d(iy, ix, seed).
__device__ __forceinline__ uint32_t hash2d_lane(uint32_t ix, uint32_t seed) {
  return (ix * 0x85EBCA6Bu) ^ (seed * 0xC2B2AE35u);
}
__device__ __forceinline__ uint32_t hash2d_row(uint32_t iy, uint32_t lane) {
  uint32_t h = (iy * 0x9E3779B9u) ^ lane;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// u8 reads and writes go through int32, as the reference's int32 hop
__device__ __forceinline__ float load_f32(const uint8_t* p, size_t i) {
  return (float)(int)p[i];
}
__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ void store(uint8_t* p, size_t i, float v) {
  p[i] = (uint8_t)(int)v;
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}

// salt (255) or pepper (0) where the element's hash falls below thresh
__device__ __forceinline__ float salt_pepper(float v, uint32_t bits,
                                             uint32_t thresh) {
  return bits < thresh ? ((bits & 1u) ? 255.0f : 0.0f) : v;
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

__device__ __forceinline__ void sort3(float a, float b, float c, float& lo,
                                      float& mid, float& hi) {
  float l = fminf(a, b);
  float h = fmaxf(a, b);
  float m = fminf(h, c);
  hi = fmaxf(h, c);
  lo = fminf(l, m);
  mid = fmaxf(l, m);
}

// The walks' two routes, chosen by the input's type:
//   * PackedMedian (u8): after salt & pepper every value is an integer in
//     [0, 255], so one 32-bit word holds a lane at both rows of a pair
//     (u16x2: row j in bits 0-15, row j + 1 in bits 16-31) and Hopper's
//     DPX three-input min/max sort both rows' columns at once:
//     lo = vimin3(a, b, c), hi = vimax3(a, b, c), mid = a + b + c - lo -
//     hi (no half exceeds 765, so nothing carries or borrows across the
//     halves; tests/test_torch_kernel_forms.py checks every u8 triple);
//   * FloatMedian (f32, any value): the same walk on float pairs with
//     sap::sort3 and the merge of the column-sort form of _median3_tile
//     (max of the los, med3 of the mids, min of the his, then med3 of
//     those), operation for operation, so NaN and signed zeros come out in
//     one order.

struct PackedMedian {
  using V = uint32_t;   // a lane at rows j (bits 0-15) and j + 1 (16-31)
  using S = uint32_t;   // one element
  static constexpr int kPairs = 4;   // pairs a step: 8 rows
  static __device__ __forceinline__ V zero() { return 0u; }
  template <typename T>
  static __device__ __forceinline__ S value(const T* p, uint32_t bits,
                                            uint32_t thresh) {
    static_assert(sizeof(T) == 1, "the packed route takes u8 images");
    const uint32_t v = *p;
    return bits < thresh ? ((bits & 1u) ? 255u : 0u) : v;
  }
  static __device__ __forceinline__ V pack(S top, S bot) {
    return __byte_perm(top, bot, 0x5410);
  }
  // (a's second row, c's first row): the pair between a and c
  static __device__ __forceinline__ V join(V a, V c) {
    return __byte_perm(a, c, 0x5432);
  }
  static __device__ __forceinline__ void sort3(V a, V b, V c, V& lo, V& mid,
                                               V& hi) {
    lo = __vimin3_u16x2(a, b, c);
    hi = __vimax3_u16x2(a, b, c);
    mid = a + b + c - lo - hi;
  }
  static __device__ __forceinline__ V max3(V l, V c, V r) {
    return __vimax3_u16x2(l, c, r);
  }
  static __device__ __forceinline__ V min3(V l, V c, V r) {
    return __vimin3_u16x2(l, c, r);
  }
  static __device__ __forceinline__ V med3(V a, V b, V c) {
    return a + b + c - __vimax3_u16x2(a, b, c) - __vimin3_u16x2(a, b, c);
  }
  static __device__ __forceinline__ V both_bot(V m) {
    return __byte_perm(m, 0, 0x3232);
  }
  static __device__ __forceinline__ V both_top(V m) {
    return __byte_perm(m, 0, 0x1010);
  }
  // (prev's second row, m's second row)
  static __device__ __forceinline__ V top_from(V m, V prev) {
    return __byte_perm(prev, m, 0x7632);
  }
  static __device__ __forceinline__ void store_top(uint8_t* p, V m) {
    *p = (uint8_t)m;
  }
  static __device__ __forceinline__ void store_bot(uint8_t* p, V m) {
    *p = (uint8_t)(m >> 16);
  }
};

struct FloatMedian {
  using V = float2;     // x: row j, y: row j + 1
  using S = float;
  static constexpr int kPairs = 2;   // pairs a step: 4 rows (the same
                                     // shared memory as PackedMedian's 8)
  static __device__ __forceinline__ V zero() { return make_float2(0.f, 0.f); }
  template <typename T>
  static __device__ __forceinline__ S value(const T* p, uint32_t bits,
                                            uint32_t thresh) {
    return salt_pepper(load_f32(p, 0), bits, thresh);
  }
  static __device__ __forceinline__ V pack(S top, S bot) {
    return make_float2(top, bot);
  }
  static __device__ __forceinline__ V join(V a, V c) {
    return make_float2(a.y, c.x);
  }
  static __device__ __forceinline__ void sort3(V a, V b, V c, V& lo, V& mid,
                                               V& hi) {
    sap::sort3(a.x, b.x, c.x, lo.x, mid.x, hi.x);
    sap::sort3(a.y, b.y, c.y, lo.y, mid.y, hi.y);
  }
  // the merge in its order: fmaxf(fmaxf(l, c), r), fminf(fminf(l, c), r),
  // sap::med3
  static __device__ __forceinline__ V max3(V l, V c, V r) {
    return make_float2(fmaxf(fmaxf(l.x, c.x), r.x),
                       fmaxf(fmaxf(l.y, c.y), r.y));
  }
  static __device__ __forceinline__ V min3(V l, V c, V r) {
    return make_float2(fminf(fminf(l.x, c.x), r.x),
                       fminf(fminf(l.y, c.y), r.y));
  }
  static __device__ __forceinline__ V med3(V a, V b, V c) {
    return make_float2(sap::med3(a.x, b.x, c.x), sap::med3(a.y, b.y, c.y));
  }
  static __device__ __forceinline__ V both_bot(V m) {
    return make_float2(m.y, m.y);
  }
  static __device__ __forceinline__ V both_top(V m) {
    return make_float2(m.x, m.x);
  }
  static __device__ __forceinline__ V top_from(V m, V prev) {
    return make_float2(prev.y, m.y);
  }
  template <typename T>
  static __device__ __forceinline__ void store_top(T* p, V m) {
    store(p, 0, m.x);
  }
  template <typename T>
  static __device__ __forceinline__ void store_bot(T* p, V m) {
    store(p, 0, m.y);
  }
};

// sorted columns of a step: [pair][lo, mid, hi][lane of a block of N]
template <typename R, int N>
using Taps = typename R::V[R::kPairs][3][N];

// A 3x3 median of a pair: the sorted columns of lanes tl and tr from the
// taps, the thread's own from registers, merged: max of the los, med3 of
// the mids, min of the his, med3 of those (the median of the nine).
template <typename R, typename V, int N>
__device__ __forceinline__ V merge(const V (&taps)[3][N], int tl, int tr,
                                   V lo, V mid, V hi) {
  return R::med3(R::max3(taps[0][tl], lo, taps[0][tr]),
                 R::med3(taps[1][tl], mid, taps[1][tr]),
                 R::min3(taps[2][tl], hi, taps[2][tr]));
}

template <bool B>
struct Edge {
  static constexpr bool value = B;
};

// Rows a segment: the fewest waves of blocks_per_sm blocks on every SM
// times the rows a block walks (the segment, 4 halo rows, rounded up to
// whole steps of `step` rows).  The kernels are bound by latency as much
// as by issue, so a wave that fills every SM's block slots beats one with
// fewer, longer blocks.
inline int seg_rows_for(int b, int h, int strips, int step,
                        int blocks_per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int best = h, best_cost = -1;
  for (int rows = h; rows >= 8; --rows) {
    const int segs = (h + rows - 1) / rows;
    if ((h + segs - 1) / segs != rows) continue;   // same segments, fewer rows
    const long long blocks = (long long)strips * segs * b;
    const long long slots = (long long)sms * blocks_per_sm;
    const long long walked = (rows + 4 + step - 1) / step * step;
    const long long cost = (blocks + slots - 1) / slots * walked;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rows;
    }
  }
  return best;
}

}  // namespace sap
