// The sun-flare ("bloom") compositing of one pixel, shared by bloom.cu
// (kernel for bloom plans) and mix_noise.cu (the bloom kind of a mix).
//
// 48 overlay/output steps from per-step scalars (cx, cy, r^2, b, g, r,
// alpha, 0) that generators.bloom_params draws outside the kernels, as
// tpudenoise/noise/pallas_bloom.py:_bloom_kernel computes them.  Steps 8
// and later are the flare-source rings; they share one centre, so their
// squared distance is computed once.  Each step rounds half to even and
// clamps to [0, 255].  Built with --fmad=false, so alpha*overlay +
// (1-alpha)*output rounds as the plain torch version's separate ops do.
//
// Two forms, bit for bit the same where both apply:
//   * composite: any inputs and params.  Each channel-step rounds with
//     rintf and clamps with a NaN test, a max and a min.
//   * composite_fast: for images whose params pass params_fast (every
//     alpha in [0, 1], step 8's exactly 1, every colour in [0, 255]) and
//     whose pixels are all in [+0, 255].  Then every blend lies in
//     [+0, 255.5) (each product and sum of values in [+0, 255] rounds by
//     less than 2^-23 relative), so the clamp and the NaN test are the
//     identity, and (x + 1.5 * 2^23) - 1.5 * 2^23, two adds on the FMA
//     pipe, is rintf (half to even below 2^22).  Step 8's alpha of 1
//     makes its output round(1 * overlay + 0 * output) = round(overlay),
//     whatever steps 0-7 blended, so those steps only move the overlay.
// generators.bloom_params always gives such params (alphas in [0, 1],
// colours in [205, 255], step 8's alpha 1: tests/test_torch_bloom.py
// holds it), and u8 images are always in range.

#pragma once

#include <stdint.h>

namespace bloom_steps {

constexpr int kSteps = 48;   // compositing steps
constexpr int kCirc = 8;     // steps with their own centre
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23

// cv2 saturate_cast<uchar>: round half-even, clamp (NaN kept, as jnp.clip)
__device__ __forceinline__ float sat_u8(float x) {
  const float r = rintf(x);
  return r != r ? r : fminf(fmaxf(r, 0.0f), 255.0f);
}

// x in [+0, 255]: not -0, NaN or inf (its bits as an unsigned compare)
__device__ __forceinline__ bool in_u8_range(float x) {
  return __float_as_uint(x) <= 0x437F0000u;
}

// Whether element j of an image's (kSteps, 8) params lets composite_fast
// run: colours in [+0, 255], alphas in [+0, 1], step 8's alpha 1.
__device__ __forceinline__ bool param_fast(int j, float v) {
  const int col = j & 7;
  const uint32_t bits = __float_as_uint(v);
  if (col == 6)
    return j == kCirc * 8 + 6 ? bits == 0x3F800000u : bits <= 0x3F800000u;
  return col < 3 || col > 5 || bits <= 0x437F0000u;
}

// composite_fast's condition for the block: all of the image's params
// pass and `mine` holds in every thread.  Every thread of the block must
// call it (a barrier).
__device__ __forceinline__ bool block_fast(const float* prm, bool mine) {
  const int nt = blockDim.x * blockDim.y;
  for (int j = threadIdx.y * blockDim.x + threadIdx.x; j < kSteps * 8;
       j += nt)
    mine = mine && param_fast(j, prm[j]);
  return __syncthreads_and(mine) != 0;
}

// prm: the image's (kSteps, 8) params; (xx, yy): the pixel's column and
// row; in[3] -> out[3].
__device__ __forceinline__ void composite(const float* prm, float xx,
                                          float yy, const float in[3],
                                          float out[3]) {
  const float sx = xx - prm[kCirc * 8 + 0], sy = yy - prm[kCirc * 8 + 1];
  const float dsrc = sx * sx + sy * sy;
  float overlay[3];
  for (int c = 0; c < 3; ++c) overlay[c] = out[c] = in[c];
  for (int s = 0; s < kSteps; ++s) {
    const float* q = prm + 8 * s;
    bool mask;
    if (s < kCirc) {
      const float dx = xx - q[0], dy = yy - q[1];
      mask = dx * dx + dy * dy <= q[2];
    } else {
      mask = dsrc <= q[2];
    }
    const float alpha = q[6];
    for (int c = 0; c < 3; ++c) {
      if (mask) overlay[c] = q[3 + c];
      out[c] = sat_u8(alpha * overlay[c] + (1.0f - alpha) * out[c]);
    }
  }
}

// rintf(x) for +0 <= x < 2^22
__device__ __forceinline__ float round_pos(float x) {
  return (x + kRound) - kRound;
}

// A step's params as two 16-byte loads: (cx, cy, r^2, b) and (g, r,
// alpha, 0).  P is float4 (16-byte aligned, shared memory) or float.
__device__ __forceinline__ void load_step(const float4* prm, int s,
                                          float4& q, float4& c) {
  q = prm[2 * s];
  c = prm[2 * s + 1];
}
__device__ __forceinline__ void load_step(const float* prm, int s, float4& q,
                                          float4& c) {
  const float* p = prm + 8 * s;
  q = make_float4(p[0], p[1], p[2], p[3]);
  c = make_float4(p[4], p[5], p[6], p[7]);
}

// composite for NP pixels of one row, columns xx[], in place in px[][3],
// under composite_fast's condition (see the top of this file).
template <int NP, typename P>
__device__ __forceinline__ void composite_fast(const P* prm,
                                               const float (&xx)[NP],
                                               float yy, float (&px)[NP][3]) {
  float4 q, c;
  // steps 0-7: the overlay only
#pragma unroll 1
  for (int s = 0; s < kCirc; ++s) {
    load_step(prm, s, q, c);
    const float dy = yy - q.y;
    const float dyy = dy * dy;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float dx = xx[p] - q.x;
      if (dx * dx + dyy <= q.z) {
        px[p][0] = q.w;
        px[p][1] = c.x;
        px[p][2] = c.y;
      }
    }
  }
  // step 8 (alpha 1): output = round(overlay); px holds the overlay from
  // here on, out the output
  load_step(prm, kCirc, q, c);
  const float sy = yy - q.y;
  const float syy = sy * sy;
  float dsrc[NP], out[NP][3];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float sx = xx[p] - q.x;
    dsrc[p] = sx * sx + syy;
    if (dsrc[p] <= q.z) {
      px[p][0] = q.w;
      px[p][1] = c.x;
      px[p][2] = c.y;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[p][ch] = round_pos(px[p][ch]);
  }
  // steps 9-47: the source rings
#pragma unroll 1
  for (int s = kCirc + 1; s < kSteps; ++s) {
    load_step(prm, s, q, c);
    const float alpha = c.z, rest = 1.0f - alpha;
    const float col[3] = {q.w, c.x, c.y};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool mask = dsrc[p] <= q.z;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (mask) px[p][ch] = col[ch];
        out[p][ch] = round_pos(alpha * px[p][ch] + rest * out[p][ch]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) px[p][ch] = out[p][ch];
}

}  // namespace bloom_steps
