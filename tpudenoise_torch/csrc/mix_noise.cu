// Fused mixed noise (+ bilateral) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpudenoise/noise/pallas_mix.py:
//   * mix_noise     <- _mix_noise_kernel / fused_mix_noise: each image runs
//     the generator its prologue drew (13 kinds, bodies _body_* at
//     pallas_mix.py:222-481);
//   * mix_bilateral <- _mix_bilateral_kernel / fused_mix_bilateral: the
//     same noise on a halo'd window, out-of-image elements zeroed
//     (BORDER_CONSTANT of the noisy image), then the d=9 bilateral of
//     tpudenoise/denoise/pallas_bilateral.py:_bilateral_body (shared with
//     the standalone bilateral in bilateral_taps.cuh).  Nothing noisy goes
//     to device memory.
//
// Layout: images (B, H, W, 3) u8 in, float32 out, interleaved.  The kind
// is per image (blockIdx.z), so a block never diverges on it.  Random
// draws are a counter hash of the element raster index (y*w + x)*3 + c,
// salted per draw, seeded by the image's two seed words: every element's
// noise is fixed whatever the tiling, so a window's halo recomputes the
// same values as its neighbour's interior.
//
// What bounds it on this card: arithmetic, not bytes.  mix_noise reads 3
// bytes and writes 12 per pixel (~43 MB for 8 x 600x1000, ~13 us at
// 3.35 TB/s), but poisson runs 33 inverse-CDF steps and 4 PTRS rounds
// with logs per element, and gamma 4 Box-Muller pairs; the cheap kinds are
// memory-bound.  mix_bilateral adds the 49 taps of each pixel and
// recomputes the noise of a 4-pixel halo: its 32 x 64 tiles recompute
// 1.41x the pixels (16 x 64 tiles: 1.69x; 32 x 128 and 64 x 64 recompute
// less but ran slower on the card, with fewer blocks resident).  The
// noisy window lives in dynamic shared memory as bilateral_taps::stage
// lays it out, with the colour-weight table (49,144 bytes, under the
// 48 KB a launch gets without opting in); a window of u8 values (every
// kind but gaussian, whose values are [0, 1] floats) takes the table form
// of the taps, any other the per-tap expf, both bit-exact against the
// plain version's bilateral.  One thread per pixel for mix_noise, strips
// of 2 pixels for the taps; scalar loads, no TMA.
//
// Brownian: the path is the exclusive prefix of sqrt(level)*N(0,1) over
// the raster (1.8M terms at 600x1000), and its f32 rounding grows like
// sqrt(n) ulps -- tens of u8 steps after *255 mod 256 -- so any two
// summation orders give visibly different images.  The TPU kernel carries
// the prefix across grid steps, which run in order there; CUDA blocks run
// in no order.  So a pre-pass (brownian_prefix) fixes one order that the
// plain torch version repeats with explicit shifted adds: each raster row
// is scanned in log steps (x[i] += x[i-k], k = 1, 2, 4, ...), then the
// row totals are scanned the same way; an element's path is its row's
// exclusive offset plus its exclusive in-row prefix.
//
// Numerics: --fmad=false and no fast math, so every float operation
// rounds where the plain version's torch ops round; the operation order
// follows pallas_mix.py term by term (x**2 is x*x, x**3 is x*(x*x)).
// jnp.mod's sign follows the divisor: wrap_u8 adds 256 to a negative
// fmodf.  jnp.round is rintf (half to even); max/min keep NaN as
// jnp.maximum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "bilateral_taps.cuh"
#include "bloom_steps.cuh"

namespace {

enum Kind {
  kOriginal = 0, kGaussian = 1, kPoisson = 2, kSap = 3, kSpeckle = 4,
  kQuant = 5, kUniform = 6, kBrownian = 7, kPeriodic = 8, kGamma = 9,
  kRayleigh = 10, kBloom = 11, kShader = 12
};

constexpr int kKPad = 10;      // quant centres per image
using bilateral_taps::kRadius;  // bilateral d=9
using bilateral_taps::Weights;
constexpr int kTileH = 32, kTileW = 64, kStrip = 2;
constexpr int kWinH = kTileH + 2 * kRadius, kWinW = kTileW + 2 * kRadius;
constexpr int kBilSmem = bilateral_taps::smem_bytes(kWinH, kWinW);
static_assert(kBilSmem <= 48 * 1024, "no opt-in to more shared memory");
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

// ------------------------------------------------------------- helpers --

__device__ __forceinline__ uint32_t hash_ctr(uint32_t ctr, uint32_t salt,
                                             uint32_t s0, uint32_t s1) {
  uint32_t h = (ctr * 0x9E3779B9u) ^ (salt * 0x85EBCA6Bu) ^ (s0 * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= s1 * 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float u01_bits(uint32_t bits) {
  return ((float)(int)(bits >> 8) + 0.5f) * (float)(1.0 / 16777216.0);
}

// NaN-propagating max/min (jnp.maximum / jnp.minimum / jnp.clip)
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minn(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return minn(maxn(x, lo), hi);
}

// numpy's float -> uint8 cast: truncate, wrap mod 256 (sign of divisor)
__device__ __forceinline__ float wrap_u8(float x) {
  const float m = fmodf(truncf(x), 256.0f);
  return m < 0.0f ? m + 256.0f : m;
}

// cv2 saturate_cast<uchar>: round half-even, clamp
__device__ __forceinline__ float sat_u8(float x) {
  return clip(rintf(x), 0.0f, 255.0f);
}

struct Image {
  int kind, h, w;
  float level, vals;
  uint32_t s0, s1;
  const float* centers;   // (kKPad * 6): lab(3), bgr(3) per centre
  const float* bloom;     // (bloom_steps::kSteps * 8)
  bool bloom_fast;        // bloom_steps::composite_fast applies
  const float* rows;      // (h, 3w) inclusive row scans (brownian)
  const float* off;       // (h,) exclusive row offsets (brownian)
};

__device__ __forceinline__ Image load_image(
    int b, int h, int w, const int* kind, const float* level,
    const int* seeds, const float* vals, const float* centers,
    const float* bloom, const float* rows, const float* off) {
  Image p;
  p.kind = kind[b];
  p.h = h;
  p.w = w;
  p.level = level[b];
  p.vals = vals[b];
  p.s0 = (uint32_t)seeds[2 * b];
  p.s1 = (uint32_t)seeds[2 * b + 1];
  p.centers = centers + (size_t)b * kKPad * 6;
  p.bloom = bloom + (size_t)b * bloom_steps::kSteps * 8;
  // u8 images are always in range: the params decide (for the whole
  // block: the kind, and so this branch, is the block's)
  p.bloom_fast = p.kind == kBloom && bloom_steps::block_fast(p.bloom, true);
  const bool brown = p.kind == kBrownian;
  p.rows = brown ? rows + (size_t)b * h * 3 * w : nullptr;
  p.off = brown ? off + (size_t)b * h : nullptr;
  return p;
}

__device__ __forceinline__ float u01(const Image& p, uint32_t ctr,
                                     uint32_t salt) {
  return u01_bits(hash_ctr(ctr, salt, p.s0, p.s1));
}

__device__ __forceinline__ float normal(const Image& p, uint32_t ctr,
                                        uint32_t salt) {
  const float u1 = u01(p, ctr, salt);
  const float u2 = u01(p, ctr, salt + 1);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

// ---------------------------------------------------------- kind bodies --

__device__ float gamma_elem(const Image& p, uint32_t ctr, float x01) {
  // f32(a - 1/3) and f32(1 / sqrt(9 (a - 1/3))) for a = 1.99
  const float d = 0x1.a81b4ep+0f;
  const float c = 0x1.093144p-2f;
  float out = 0.0f, last = d;
  bool ok = false;
  for (int r = 0; r < 4; ++r) {
    const float x = normal(p, ctr, 32 + 3 * r);
    const float u = u01(p, ctr, 34 + 3 * r);
    const float t = 1.0f + c * x;
    const float v = t * (t * t);
    const bool pos = v > 0.0f;
    const float vs = pos ? v : 1.0f;
    const bool accept =
        pos && (logf(u) < (0.5f * x) * x + d * ((1.0f - vs) + logf(vs)));
    const float cand = d * vs;
    if (accept && !ok) out = cand;
    ok = ok || accept;
    if (pos) last = cand;
  }
  const float g = ok ? out : last;
  return wrap_u8(255.0f * (x01 + g * p.level));
}

__device__ float stirling_lgamma(float z) {
  const float t = z + 8.0f;
  const float inv = 1.0f / t;
  float pr = z * inv;
  for (int i = 1; i < 8; ++i) pr = pr * ((z + (float)i) * inv);
  pr = maxn(pr, (float)1e-30);
  const float inv2 = inv * inv;
  const float series =
      inv * ((float)(1.0 / 12.0) - inv2 * (float)(1.0 / 360.0));
  return ((((t - 8.5f) * logf(t) - t) + (float)0.91893853320467274178) +
          series) -
         logf(pr);
}

__constant__ float kInvN[34] = {
    0.0f,
    (float)(1.0 / 1),  (float)(1.0 / 2),  (float)(1.0 / 3),  (float)(1.0 / 4),
    (float)(1.0 / 5),  (float)(1.0 / 6),  (float)(1.0 / 7),  (float)(1.0 / 8),
    (float)(1.0 / 9),  (float)(1.0 / 10), (float)(1.0 / 11), (float)(1.0 / 12),
    (float)(1.0 / 13), (float)(1.0 / 14), (float)(1.0 / 15), (float)(1.0 / 16),
    (float)(1.0 / 17), (float)(1.0 / 18), (float)(1.0 / 19), (float)(1.0 / 20),
    (float)(1.0 / 21), (float)(1.0 / 22), (float)(1.0 / 23), (float)(1.0 / 24),
    (float)(1.0 / 25), (float)(1.0 / 26), (float)(1.0 / 27), (float)(1.0 / 28),
    (float)(1.0 / 29), (float)(1.0 / 30), (float)(1.0 / 31), (float)(1.0 / 32),
    (float)(1.0 / 33)};

__device__ float poisson_elem(const Image& p, uint32_t ctr, float x01) {
  const float vals = p.vals;
  const float lam = x01 * vals;
  const bool small = lam < 10.0f;

  const float u = u01(p, ctr, 1);
  const float lam_s = minn(lam, 10.0f);
  float prob = expf(-lam_s);
  float cdf = prob;
  float k_small = 0.0f;
  for (int n = 1; n < 34; ++n) {
    if (u > cdf) k_small = (float)n;
    prob = (prob * lam_s) * kInvN[n];
    cdf = cdf + prob;
  }

  const float lam_b = maxn(lam, 10.0f);
  const float b = (float)0.931 + (float)2.53 * sqrtf(lam_b);
  const float a = (float)-0.059 + (float)0.02483 * b;
  const float inv_alpha = (float)1.1239 + (float)1.1328 / (b - (float)3.4);
  const float v_r = (float)0.9277 - (float)3.6224 / (b - 2.0f);
  const float log_lam = logf(lam_b);
  float k_big = 0.0f;
  bool ok = false;
  for (int r = 0; r < 4; ++r) {
    const uint32_t wd = hash_ctr(ctr, 16 + r, p.s0, p.s1);
    const float uu =
        ((float)(int)(wd >> 16) + 0.5f) * (float)(1.0 / 65536.0) - 0.5f;
    const float vv =
        ((float)(int)(wd & 0xFFFFu) + 0.5f) * (float)(1.0 / 65536.0);
    const float us = 0.5f - fabsf(uu);
    const float cand =
        floorf((((2.0f * a) / us + b) * uu + lam_b) + (float)0.43);
    bool accept = (us >= (float)0.07) && (vv <= v_r);
    const bool safe = (cand >= 0.0f) && ((us >= (float)0.013) || (vv <= us));
    const float lhs = logf((vv * inv_alpha) / (a / (us * us) + b));
    const float rhs = (-lam_b + cand * log_lam) - stirling_lgamma(cand + 1.0f);
    accept = accept || (safe && (lhs <= rhs));
    if (accept && !ok) k_big = cand;
    ok = ok || accept;
  }
  const float z = normal(p, ctr, 8);
  const float fallback = maxn(rintf(lam_b + sqrtf(lam_b) * z), 0.0f);
  if (!ok) k_big = fallback;
  const float k = small ? k_small : k_big;
  return wrap_u8(255.0f * clip(k / vals, 0.0f, 1.0f));
}

// kernel-inlined cv2 BGR2LAB (exp/log powers, not ops/color.py's forms)
__device__ __forceinline__ float srgb_lin(float v) {
  v = v * kInv255;
  const float pw = expf(logf(maxn((v + (float)0.055) * (float)(1.0 / 1.055),
                                  (float)1e-12)) *
                        (float)2.4);
  return v > (float)0.04045 ? pw : v * (float)(1.0 / 12.92);
}

__device__ __forceinline__ float cbrt_pos(float t) {
  return expf(logf(maxn(t, (float)1e-30)) * (float)(1.0 / 3.0));
}

__device__ __forceinline__ float flab(float t) {
  return t > (float)0.008856 ? cbrt_pos(t)
                             : (float)7.787 * t + (float)(16.0 / 116.0);
}

__device__ void quant_pixel(const Image& p, const float in[3], float out[3]) {
  const float lb = srgb_lin(in[0]), lg = srgb_lin(in[1]), lr = srgb_lin(in[2]);
  const float x = (((float)0.412453 * lr + (float)0.357580 * lg) +
                   (float)0.180423 * lb) *
                  (float)(1.0 / 0.950456);
  const float y = ((float)0.212671 * lr + (float)0.715160 * lg) +
                  (float)0.072169 * lb;
  const float zc = (((float)0.019334 * lr + (float)0.119193 * lg) +
                    (float)0.950227 * lb) *
                   (float)(1.0 / 1.088754);
  const float lv = y > (float)0.008856 ? 116.0f * cbrt_pos(y) - 16.0f
                                       : (float)903.3 * y;
  const float fx = flab(x), fy = flab(y), fz = flab(zc);
  const float l8 = clip(rintf(lv * (float)(255.0 / 100.0)), 0.0f, 255.0f);
  const float a8 = clip(rintf(500.0f * (fx - fy) + 128.0f), 0.0f, 255.0f);
  const float b8 = clip(rintf(200.0f * (fy - fz) + 128.0f), 0.0f, 255.0f);
  float best = 1e30f;
  out[0] = out[1] = out[2] = 0.0f;
  for (int k = 0; k < kKPad; ++k) {
    const float* c = p.centers + 6 * k;
    const float dl = l8 - c[0], da = a8 - c[1], db = b8 - c[2];
    const float d = (dl * dl + da * da) + db * db;
    if (d < best) {
      best = d;
      out[0] = c[3];
      out[1] = c[4];
      out[2] = c[5];
    }
  }
}

// The noisy value of pixel (y, x) of image p: in[3] -> out[3].
__device__ void noisy_pixel(const Image& p, int y, int x, const float in[3],
                            float out[3]) {
  const uint32_t ctr0 = (uint32_t)((y * p.w + x) * 3);
  switch (p.kind) {
    case kGaussian: {
      const float sd = sqrtf(p.level);
      for (int c = 0; c < 3; ++c) {
        const float z = normal(p, ctr0 + c, 64);
        out[c] = clip(in[c] * kInv255 + z * sd, 0.0f, 1.0f);
      }
      return;
    }
    case kPoisson:
      for (int c = 0; c < 3; ++c)
        out[c] = poisson_elem(p, ctr0 + c, in[c] * kInv255);
      return;
    case kSap:
      for (int c = 0; c < 3; ++c) {
        const uint32_t bits = hash_ctr(ctr0 + c, 70, p.s0, p.s1);
        const bool flipped = u01_bits(bits) < p.level;
        out[c] = flipped ? ((bits & 1u) ? 255.0f : 0.0f) : in[c];
      }
      return;
    case kSpeckle: {
      const float sd = sqrtf(p.level);
      for (int c = 0; c < 3; ++c) {
        const float z = normal(p, ctr0 + c, 66);
        const float x01 = in[c] * kInv255;
        out[c] = wrap_u8(255.0f * clip(x01 + (x01 * z) * sd, 0.0f, 1.0f));
      }
      return;
    }
    case kQuant:
      quant_pixel(p, in, out);
      return;
    case kUniform:
      for (int c = 0; c < 3; ++c)
        out[c] = wrap_u8(255.0f *
                         (in[c] * kInv255 + u01(p, ctr0 + c, 68) * p.level));
      return;
    case kBrownian: {
      const float* row = p.rows + (size_t)y * 3 * p.w;
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * x + c;
        const float path = p.off[y] + (i > 0 ? row[i - 1] : 0.0f);
        out[c] = sat_u8(in[c] + wrap_u8(path * 255.0f));
      }
      return;
    }
    case kPeriodic: {
      const float n = (float)(p.h * p.w * 3);
      const float amp = p.level < 0.0f ? n : p.level;
      const float step = (2.0f * amp) / (n - 1.0f);
      for (int c = 0; c < 3; ++c) {
        const float t = -amp + (float)(int)(ctr0 + c) * step;
        out[c] = sat_u8(in[c] + wrap_u8(sinf(t) * 255.0f));
      }
      return;
    }
    case kGamma:
      for (int c = 0; c < 3; ++c)
        out[c] = gamma_elem(p, ctr0 + c, in[c] * kInv255);
      return;
    case kRayleigh:
      for (int c = 0; c < 3; ++c) {
        const float u = u01(p, ctr0 + c, 69);
        out[c] = wrap_u8(255.0f * (in[c] * kInv255 +
                                   p.level * sqrtf(-2.0f * logf(u))));
      }
      return;
    case kBloom: {
      if (!p.bloom_fast) {
        bloom_steps::composite(p.bloom, (float)x, (float)y, in, out);
        return;
      }
      const float xx[1] = {(float)x};
      float px[1][3] = {{in[0], in[1], in[2]}};
      bloom_steps::composite_fast<1>(p.bloom, xx, (float)y, px);
      for (int c = 0; c < 3; ++c) out[c] = px[0][c];
      return;
    }
    case kShader:
      out[0] = sat_u8(in[2] * 3.0f);
      out[1] = sat_u8(in[1] * 3.0f);
      out[2] = sat_u8(in[0] * 3.0f);
      return;
    default:  // kOriginal
      for (int c = 0; c < 3; ++c) out[c] = in[c];
  }
}

// ---------------------------------------------------- brownian prefix --

// Inclusive Hillis-Steele scan of n floats in shared memory: a[i] +=
// a[i-k] for k = 1, 2, 4, ..., double-buffered.  Returns the buffer that
// holds the result.
__device__ float* log_step_scan(float* a, float* tmp, int n) {
  for (int k = 1; k < n; k <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tmp[i] = i >= k ? a[i] + a[i - k] : a[i];
    __syncthreads();
    float* t = a;
    a = tmp;
    tmp = t;
  }
  return a;
}

// One block per (row, image): the row's increments, scanned.
__global__ void __launch_bounds__(kScanThreads)
brownian_rows_kernel(const int* __restrict__ kind,
                     const float* __restrict__ level,
                     const int* __restrict__ seeds, float* __restrict__ rows,
                     float* __restrict__ tot, int h, int w3) {
  extern __shared__ float buf[];
  const int b = blockIdx.y, y = blockIdx.x;
  if (kind[b] != kBrownian) return;
  Image p;
  p.s0 = (uint32_t)seeds[2 * b];
  p.s1 = (uint32_t)seeds[2 * b + 1];
  const float sd = sqrtf(level[b]);
  for (int i = threadIdx.x; i < w3; i += blockDim.x)
    buf[i] = normal(p, (uint32_t)(y * w3 + i), 72) * sd;
  __syncthreads();
  const float* s = log_step_scan(buf, buf + w3, w3);
  float* dst = rows + ((size_t)b * h + y) * w3;
  for (int i = threadIdx.x; i < w3; i += blockDim.x) dst[i] = s[i];
  if (threadIdx.x == 0) tot[(size_t)b * h + y] = s[w3 - 1];
}

// One block per image: exclusive scan of the row totals.
__global__ void __launch_bounds__(kScanThreads)
brownian_offsets_kernel(const int* __restrict__ kind,
                        const float* __restrict__ tot,
                        float* __restrict__ off, int h) {
  extern __shared__ float buf[];
  const int b = blockIdx.x;
  if (kind[b] != kBrownian) return;
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    buf[i] = tot[(size_t)b * h + i];
  __syncthreads();
  const float* s = log_step_scan(buf, buf + h, h);
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    off[(size_t)b * h + i] = i > 0 ? s[i - 1] : 0.0f;
}

// ------------------------------------------------------------ kernels --

__global__ void __launch_bounds__(kThreads)
mix_noise_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                 const int* __restrict__ kind, const float* __restrict__ level,
                 const int* __restrict__ seeds,
                 const float* __restrict__ vals,
                 const float* __restrict__ centers,
                 const float* __restrict__ bloom,
                 const float* __restrict__ rows,
                 const float* __restrict__ off, int h, int w) {
  const int b = blockIdx.z, y = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const Image p =
      load_image(b, h, w, kind, level, seeds, vals, centers, bloom, rows, off);
  if (x >= w) return;
  const size_t e = (((size_t)b * h + y) * w + x) * 3;
  float px[3], o[3];
  for (int c = 0; c < 3; ++c) px[c] = (float)(int)in[e + c];
  noisy_pixel(p, y, x, px, o);
  for (int c = 0; c < 3; ++c) out[e + c] = o[c];
}

__global__ void __launch_bounds__(kThreads)
mix_bilateral_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                     const int* __restrict__ kind,
                     const float* __restrict__ level,
                     const int* __restrict__ seeds,
                     const float* __restrict__ vals,
                     const float* __restrict__ centers,
                     const float* __restrict__ bloom,
                     const float* __restrict__ rows,
                     const float* __restrict__ off,
                     const __grid_constant__ Weights sw, float gc, int h,
                     int w) {
  extern __shared__ float smem[];
  auto win = reinterpret_cast<float (*)[kWinH][kWinW]>(smem);
  float* lut = smem + 4 * kWinH * kWinW;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const Image p =
      load_image(b, h, w, kind, level, seeds, vals, centers, bloom, rows, off);
  bilateral_taps::fill_lut(lut, gc);
  bool u8 = true;
  for (int i = threadIdx.x; i < kWinH * kWinW; i += blockDim.x) {
    const int wy = i / kWinW, wx = i % kWinW;
    const int y = r0 - kRadius + wy, x = c0 - kRadius + wx;
    float o[3] = {0.0f, 0.0f, 0.0f};   // BORDER_CONSTANT of the noisy image
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t e = (((size_t)b * h + y) * w + x) * 3;
      float px[3];
      for (int c = 0; c < 3; ++c) px[c] = (float)(int)in[e + c];
      noisy_pixel(p, y, x, px, o);
    }
    u8 = u8 & bilateral_taps::stage(win, wy, wx, o);
  }
  const bool table = __syncthreads_and(u8);
  bilateral_taps::filter_tile<kTileH, kTileW, kStrip, kWinH, kWinW>(
      win, table, sw, gc, lut, out, b, h, w, r0, c0);
}

int scan_smem(const void* fn, int n) {
  const int bytes = 2 * n * (int)sizeof(float);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  return bytes;
}

}  // namespace

extern "C" {

int brownian_prefix(const void* kind, const void* level, const void* seeds,
                    void* rows, void* tot, void* off, int b, int h, int w3,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int rb = scan_smem((const void*)brownian_rows_kernel, w3);
  brownian_rows_kernel<<<dim3(h, b), kScanThreads, rb, s>>>(
      (const int*)kind, (const float*)level, (const int*)seeds, (float*)rows,
      (float*)tot, h, w3);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int ob = scan_smem((const void*)brownian_offsets_kernel, h);
  brownian_offsets_kernel<<<b, kScanThreads, ob, s>>>(
      (const int*)kind, (const float*)tot, (float*)off, h);
  return (int)cudaGetLastError();
}

int mix_noise(const void* in, void* out, const void* kind, const void* level,
              const void* seeds, const void* vals, const void* centers,
              const void* bloom, const void* rows, const void* off, int b,
              int h, int w, void* stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, h, b);
  mix_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, (const int*)kind, (const float*)level,
      (const int*)seeds, (const float*)vals, (const float*)centers,
      (const float*)bloom, (const float*)rows, (const float*)off, h, w);
  return (int)cudaGetLastError();
}

// sw: HOST pointer to the 49 spatial weights in tap order (they go to the
// kernel as a parameter); every other pointer is on the device.
int mix_bilateral(const void* in, void* out, const void* kind,
                  const void* level, const void* seeds, const void* vals,
                  const void* centers, const void* bloom, const void* rows,
                  const void* off, const void* sw, float gc, int b, int h,
                  int w, void* stream) {
  Weights wt;
  memcpy(wt.v, sw, sizeof(wt.v));
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  mix_bilateral_kernel<<<grid, kThreads, kBilSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, (const int*)kind, (const float*)level,
      (const int*)seeds, (const float*)vals, (const float*)centers,
      (const float*)bloom, (const float*)rows, (const float*)off, wt, gc, h,
      w);
  return (int)cudaGetLastError();
}

}  // extern "C"
