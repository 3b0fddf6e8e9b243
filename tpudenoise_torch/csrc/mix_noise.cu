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
// 3.35 TB/s), but poisson runs up to 33 inverse-CDF steps or up to 4 PTRS
// rounds with logs per element, and gamma up to 4 Box-Muller pairs; the
// cheap kinds are memory-bound.  mix_bilateral adds the 49 taps of each
// pixel and recomputes the noise of a 4-pixel halo: its 32 x 64 tiles
// recompute 1.41x the pixels (16 x 64 tiles: 1.69x; 32 x 128 and 64 x 64
// recompute less but ran slower on the card, with fewer blocks
// resident).  The
// noisy window lives in dynamic shared memory as bilateral_taps::stage
// lays it out, with the colour-weight table (49,144 bytes, under the
// 48 KB a launch gets without opting in); a window of u8 values (every
// kind but gaussian, whose values are [0, 1] floats) takes the table form
// of the taps, any other the per-tap expf, both bit-exact against the
// plain version's bilateral.  Strips of 2 pixels for the taps; scalar
// loads, no TMA.
//
// mix_noise: a thread takes 4 consecutive pixels of the image's raster, so
// no block idles at the end of a row.  Where every image starts aligned
// (H*W a multiple of 4) a warp moves its 128 pixels through shared memory:
// 384 bytes in as three 128-byte rows of words, 1536 out as three 512-byte
// rows of float4s, every access whole and contiguous.  The samplers branch
// per element where the TPU, whose vector lanes cannot, evaluates every
// branch and selects: poisson runs the inverse CDF only for lam < 10
// and up to the step that decides k, PTRS only for the others and up to
// the first accepted round, its fallback normal only where no round
// accepts; gamma stops at its first accepted round.  The skipped work never
// reached the output (later rounds and the fallback draw from their own
// salts), so the values are the same.  In mix_noise a thread walks its
// poisson or gamma elements one round at a time (poisson_block,
// gamma_block), so lanes whose element accepted move on while the others
// draw again; mix_bilateral's staging takes a pixel's three channels in
// lockstep through noisy_pixel, so the compiler keeps three independent
// chains to interleave.
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
constexpr int kPix = 4;                        // kernel 6: pixels a thread
constexpr int kBlockPix = kThreads * kPix;     // kernel 6: pixels a block
constexpr int kWarps = kThreads / 32;
constexpr int kMixBlocksPerSm = 6;             // kernel 6: launch bounds
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

// f32(a - 1/3) and f32(1 / sqrt(9 (a - 1/3))) for a = 1.99
constexpr float kGammaD = 0x1.a81b4ep+0f;
constexpr float kGammaC = 0x1.093144p-2f;

struct GammaRound {
  bool pos, accept;
  float cand;
};

// Marsaglia-Tsang round r: a normal (salts 32 + 3r, 33 + 3r) and a uniform
// (34 + 3r); each round draws from its own salts
__device__ __forceinline__ GammaRound gamma_round(const Image& p,
                                                  uint32_t ctr, int r) {
  const float x = normal(p, ctr, 32 + 3 * r);
  const float u = u01(p, ctr, 34 + 3 * r);
  const float t = 1.0f + kGammaC * x;
  const float v = t * (t * t);
  GammaRound g;
  g.pos = v > 0.0f;
  const float vs = g.pos ? v : 1.0f;
  g.accept = g.pos & (logf(u) < (0.5f * x) * x +
                                    kGammaD * ((1.0f - vs) + logf(vs)));
  g.cand = kGammaD * vs;
  return g;
}

__device__ __forceinline__ float gamma_out(const Image& p, float x01,
                                           float g) {
  return wrap_u8(255.0f * (x01 + g * p.level));
}

// A pixel's three channels in lockstep (three independent chains for the
// compiler to interleave), each taking the first accepted round's
// candidate, else the last round's with v > 0 (d where none).  The
// reference runs all four rounds and selects; no round after a channel's
// first accept changes its value, so a channel stops there and the loop
// when all three have.
__device__ __forceinline__ void gamma_pixel(const Image& p, uint32_t ctr0,
                                            const float in[3],
                                            float out[3]) {
  float last[3] = {kGammaD, kGammaD, kGammaD};
  bool pend[3] = {true, true, true};
  for (int r = 0; r < 4 && (pend[0] || pend[1] || pend[2]); ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const GammaRound g = gamma_round(p, ctr0 + c, r);
      if (pend[c] && g.pos) last[c] = g.cand;
      pend[c] = pend[c] && !g.accept;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = gamma_out(p, in[c] * kInv255, last[c]);
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

// Inverse CDF for lam < 10 (salt 1): k is the last n with u > cdf(n - 1).
// Where lam >= 0, every prob is >= 0 and an f32 add of a non-negative term
// never lowers cdf, so once u <= cdf no later step can set k: the loop
// stops there (elsewhere it runs its 33 steps, as the reference's).
__device__ __forceinline__ float poisson_small(const Image& p, uint32_t ctr,
                                               float lam) {
  const float u = u01(p, ctr, 1);
  const float lam_s = minn(lam, 10.0f);
  const bool rising = lam_s >= 0.0f;
  float prob = expf(-lam_s);
  float cdf = prob;
  float k = 0.0f;
  for (int n = 1; n < 34; ++n) {
    if (u > cdf)
      k = (float)n;
    else if (rising)
      break;
    prob = (prob * lam_s) * kInvN[n];
    cdf = cdf + prob;
  }
  return k;
}

// Hoermann's PTRS for lam >= 10 (and NaN): the per-element constants
struct Ptrs {
  float lam, b, a, inv_alpha, v_r, log_lam;
};

__device__ __forceinline__ Ptrs ptrs_setup(float lam) {
  Ptrs s;
  s.lam = maxn(lam, 10.0f);
  s.b = (float)0.931 + (float)2.53 * sqrtf(s.lam);
  s.a = (float)-0.059 + (float)0.02483 * s.b;
  s.inv_alpha = (float)1.1239 + (float)1.1328 / (s.b - (float)3.4);
  s.v_r = (float)0.9277 - (float)3.6224 / (s.b - 2.0f);
  s.log_lam = logf(s.lam);
  return s;
}

// PTRS round r (salt 16 + r): whether it accepts; its candidate in cand.
// Both tests run, branch-free (a warp's lanes rarely agree on the quick
// one).
__device__ __forceinline__ bool ptrs_round(const Image& p, uint32_t ctr,
                                           int r, const Ptrs& s,
                                           float& cand) {
  const uint32_t wd = hash_ctr(ctr, 16 + r, p.s0, p.s1);
  const float uu =
      ((float)(int)(wd >> 16) + 0.5f) * (float)(1.0 / 65536.0) - 0.5f;
  const float vv =
      ((float)(int)(wd & 0xFFFFu) + 0.5f) * (float)(1.0 / 65536.0);
  const float us = 0.5f - fabsf(uu);
  cand = floorf((((2.0f * s.a) / us + s.b) * uu + s.lam) + (float)0.43);
  const bool quick = (us >= (float)0.07) & (vv <= s.v_r);
  const bool safe = (cand >= 0.0f) & ((us >= (float)0.013) | (vv <= us));
  const float lhs = logf((vv * s.inv_alpha) / (s.a / (us * us) + s.b));
  const float rhs =
      (-s.lam + cand * s.log_lam) - stirling_lgamma(cand + 1.0f);
  return quick | (safe & (lhs <= rhs));
}

// the rounded normal (salt 8) where no PTRS round accepted
__device__ __forceinline__ float poisson_fallback(const Image& p,
                                                  uint32_t ctr, float lam) {
  const float z = normal(p, ctr, 8);
  return maxn(rintf(lam + sqrtf(lam) * z), 0.0f);
}

__device__ __forceinline__ float poisson_out(const Image& p, float k) {
  return wrap_u8(255.0f * clip(k / p.vals, 0.0f, 1.0f));
}

// A pixel's three channels in lockstep (three independent chains for the
// compiler to interleave).  The reference evaluates both samplers, all
// four PTRS rounds and the fallback for every element and selects; here a
// channel runs only the sampler its lam selects and stops where its value
// is decided: the inverse CDF at its deciding step (where lam >= 0), PTRS
// at its first accepted round, the fallback normal only where no round
// accepted (each round and the fallback draw from their own salts, so the
// draws that run are the same).  Each loop ends when all three channels
// have left it.
__device__ __forceinline__ void poisson_pixel(const Image& p, uint32_t ctr0,
                                              const float in[3],
                                              float out[3]) {
  float lam[3], k[3];
  bool live[3], pend[3];   // in the inverse CDF / in PTRS
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lam[c] = (in[c] * kInv255) * p.vals;
    k[c] = 0.0f;
    live[c] = lam[c] < 10.0f;
    pend[c] = !live[c];
  }
  if (live[0] || live[1] || live[2]) {
    float u[3], lam_s[3], prob[3], cdf[3];
    bool rising[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = u01(p, ctr0 + c, 1);
      lam_s[c] = minn(lam[c], 10.0f);
      rising[c] = lam_s[c] >= 0.0f;
      prob[c] = expf(-lam_s[c]);
      cdf[c] = prob[c];
    }
    for (int n = 1; n < 34 && (live[0] || live[1] || live[2]); ++n) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const bool up = u[c] > cdf[c];
        if (live[c] && up) k[c] = (float)n;
        live[c] = live[c] && (up || !rising[c]);
        prob[c] = (prob[c] * lam_s[c]) * kInvN[n];
        cdf[c] = cdf[c] + prob[c];
      }
    }
  }
  if (pend[0] || pend[1] || pend[2]) {
    Ptrs s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = ptrs_setup(lam[c]);
    for (int r = 0; r < 4 && (pend[0] || pend[1] || pend[2]); ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float cand;
        const bool ok = ptrs_round(p, ctr0 + c, r, s[c], cand);
        if (pend[c] && ok) k[c] = cand;
        pend[c] = pend[c] && !ok;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (pend[c]) k[c] = poisson_fallback(p, ctr0 + c, s[c].lam);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = poisson_out(p, k[c]);
}

// Kernel 6's poisson and gamma images: each thread walks its elements e =
// lo + threadIdx.x, + kThreads, ... (e is the element's raster index, the
// draws' counter), one PTRS or Marsaglia-Tsang round an iteration, so a
// lane whose element accepted takes its next element while its warp's
// other lanes draw their next round: a warp runs about as many rounds as
// its lanes need, not the most any element of each step needs.  The values
// are poisson_pixel's and gamma_pixel's; through noisy_pixels (4 pixels a
// thread, the channels in lockstep) the same images ran 2-3x slower on an
// H100 (PERF.md, section 6).
__device__ void poisson_block(const Image& p, const uint8_t* in, float* out,
                              int lo, int hi) {
  int e = lo + threadIdx.x, r = -1;   // r < 0: element e not set up
  Ptrs s;
  while (e < hi) {
    if (r < 0) {
      const float lam = ((float)(int)in[e] * kInv255) * p.vals;
      if (lam < 10.0f) {
        out[e] = poisson_out(p, poisson_small(p, (uint32_t)e, lam));
        e += kThreads;
        continue;
      }
      s = ptrs_setup(lam);
      r = 0;
    }
    float cand;
    const bool ok = ptrs_round(p, (uint32_t)e, r, s, cand);
    if (ok || r == 3) {
      out[e] = poisson_out(
          p, ok ? cand : poisson_fallback(p, (uint32_t)e, s.lam));
      e += kThreads;
      r = -1;
    } else {
      ++r;
    }
  }
}

__device__ void gamma_block(const Image& p, const uint8_t* in, float* out,
                            int lo, int hi) {
  int e = lo + threadIdx.x, r = 0;
  float last = kGammaD;
  while (e < hi) {
    const GammaRound g = gamma_round(p, (uint32_t)e, r);
    if (g.pos) last = g.cand;
    if (g.accept || r == 3) {
      out[e] = gamma_out(p, (float)(int)in[e] * kInv255, last);
      e += kThreads;
      r = 0;
      last = kGammaD;
    } else {
      ++r;
    }
  }
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

// The noisy values of NP pixels of image p, pixel i at (ys[i], xs[i]):
// in -> out.  kSamplers false leaves out poisson and gamma (kernel 6 runs
// them in poisson_block / gamma_block): such images must not come here.
template <int NP, bool kSamplers>
__device__ __forceinline__ void noisy_pixels(const Image& p,
                                             const int (&ys)[NP],
                                             const int (&xs)[NP],
                                             const float (&in)[NP][3],
                                             float (&out)[NP][3]) {
  uint32_t ctr0[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    ctr0[i] = (uint32_t)((ys[i] * p.w + xs[i]) * 3);
  switch (p.kind) {
    case kGaussian: {
      const float sd = sqrtf(p.level);
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float z = normal(p, ctr0[i] + c, 64);
          out[i][c] = clip(in[i][c] * kInv255 + z * sd, 0.0f, 1.0f);
        }
      return;
    }
    case kSap:
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const uint32_t bits = hash_ctr(ctr0[i] + c, 70, p.s0, p.s1);
          const bool flipped = u01_bits(bits) < p.level;
          out[i][c] = flipped ? ((bits & 1u) ? 255.0f : 0.0f) : in[i][c];
        }
      return;
    case kSpeckle: {
      const float sd = sqrtf(p.level);
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float z = normal(p, ctr0[i] + c, 66);
          const float x01 = in[i][c] * kInv255;
          out[i][c] =
              wrap_u8(255.0f * clip(x01 + (x01 * z) * sd, 0.0f, 1.0f));
        }
      return;
    }
    case kQuant:
#pragma unroll
      for (int i = 0; i < NP; ++i) quant_pixel(p, in[i], out[i]);
      return;
    case kUniform:
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          out[i][c] = wrap_u8(255.0f * (in[i][c] * kInv255 +
                                        u01(p, ctr0[i] + c, 68) * p.level));
      return;
    case kBrownian:
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float* row = p.rows + (size_t)ys[i] * 3 * p.w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int e = 3 * xs[i] + c;
          const float path = p.off[ys[i]] + (e > 0 ? row[e - 1] : 0.0f);
          out[i][c] = sat_u8(in[i][c] + wrap_u8(path * 255.0f));
        }
      }
      return;
    case kPeriodic: {
      const float n = (float)(p.h * p.w * 3);
      const float amp = p.level < 0.0f ? n : p.level;
      const float step = (2.0f * amp) / (n - 1.0f);
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t = -amp + (float)(int)(ctr0[i] + c) * step;
          out[i][c] = sat_u8(in[i][c] + wrap_u8(sinf(t) * 255.0f));
        }
      return;
    }
    case kRayleigh:
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float u = u01(p, ctr0[i] + c, 69);
          out[i][c] = wrap_u8(255.0f * (in[i][c] * kInv255 +
                                        p.level * sqrtf(-2.0f * logf(u))));
        }
      return;
    case kBloom: {
      if (!p.bloom_fast) {
#pragma unroll
        for (int i = 0; i < NP; ++i)
          bloom_steps::composite(p.bloom, (float)xs[i], (float)ys[i], in[i],
                                 out[i]);
        return;
      }
      float xx[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        xx[i] = (float)xs[i];
#pragma unroll
        for (int c = 0; c < 3; ++c) out[i][c] = in[i][c];
      }
      if (ys[0] == ys[NP - 1]) {   // one row: NP pixels a step
        bloom_steps::composite_fast<NP>(p.bloom, xx, (float)ys[0], out);
        return;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float x1[1] = {xx[i]};
        float px[1][3] = {{out[i][0], out[i][1], out[i][2]}};
        bloom_steps::composite_fast<1>(p.bloom, x1, (float)ys[i], px);
#pragma unroll
        for (int c = 0; c < 3; ++c) out[i][c] = px[0][c];
      }
      return;
    }
    case kShader:
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        out[i][0] = sat_u8(in[i][2] * 3.0f);
        out[i][1] = sat_u8(in[i][1] * 3.0f);
        out[i][2] = sat_u8(in[i][0] * 3.0f);
      }
      return;
    case kPoisson:
      if constexpr (kSamplers) {
#pragma unroll
        for (int i = 0; i < NP; ++i) poisson_pixel(p, ctr0[i], in[i], out[i]);
        return;
      }
      break;
    case kGamma:
      if constexpr (kSamplers) {
#pragma unroll
        for (int i = 0; i < NP; ++i) gamma_pixel(p, ctr0[i], in[i], out[i]);
        return;
      }
      break;
    default:  // kOriginal
      break;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[i][c] = in[i][c];
}

// The noisy value of pixel (y, x) of image p: in[3] -> out[3].
__device__ void noisy_pixel(const Image& p, int y, int x, const float in[3],
                            float out[3]) {
  const int ys[1] = {y}, xs[1] = {x};
  const float px[1][3] = {{in[0], in[1], in[2]}};
  float o[1][3];
  noisy_pixels<1, true>(p, ys, xs, px, o);
  for (int c = 0; c < 3; ++c) out[c] = o[0][c];
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

// kernel 6: a block takes kBlockPix pixels of one image's raster (so its
// kind is the block's), a thread kPix consecutive ones; with vec, a warp
// whose 128 pixels are all in the image loads and stores them whole
// through shared memory.  Poisson and gamma images go through
// poisson_block / gamma_block instead.
__global__ void __launch_bounds__(kThreads, kMixBlocksPerSm)
mix_noise_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                 const int* __restrict__ kind, const float* __restrict__ level,
                 const int* __restrict__ seeds,
                 const float* __restrict__ vals,
                 const float* __restrict__ centers,
                 const float* __restrict__ bloom,
                 const float* __restrict__ rows,
                 const float* __restrict__ off, int h, int w, int vec) {
  __shared__ uint32_t words[kWarps][3 * 32];   // a warp's 384 bytes in
  __shared__ float4 quads[kWarps][3 * 32];     // a warp's 1536 bytes out
  const int b = blockIdx.y;
  const Image p =
      load_image(b, h, w, kind, level, seeds, vals, centers, bloom, rows, off);
  const int npix = h * w;
  const size_t img = (size_t)b * npix * 3;
  const int lo = blockIdx.x * kBlockPix;
  if (p.kind == kPoisson || p.kind == kGamma) {
    const int hi = min(lo + kBlockPix, npix) * 3;
    if (p.kind == kPoisson)
      poisson_block(p, in + img, out + img, 3 * lo, hi);
    else
      gamma_block(p, in + img, out + img, 3 * lo, hi);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wp0 = lo + warp * 32 * kPix;    // the warp's first pixel
  const bool whole = vec && wp0 + 32 * kPix <= npix;   // the warp's
  const int p0 = wp0 + kPix * lane;
  if (p0 >= npix) return;
  // past the raster: the last pixel again
  const int n = min(kPix, npix - p0);
  int ys[kPix], xs[kPix];
  ys[0] = p0 / w;
  xs[0] = p0 - ys[0] * w;
#pragma unroll
  for (int i = 1; i < kPix; ++i) {
    const bool next = i < n;
    const bool wrap = next && xs[i - 1] + 1 == w;
    ys[i] = ys[i - 1] + (wrap ? 1 : 0);
    xs[i] = wrap ? 0 : xs[i - 1] + (next ? 1 : 0);
  }
  float px[kPix][3], o[kPix][3];
  if (whole) {
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(in + img + (size_t)wp0 * 3);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      words[warp][lane + 32 * j] = src[lane + 32 * j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t word = words[warp][3 * lane + j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        px[(4 * j + k) / 3][(4 * j + k) % 3] =
            (float)((word >> (8 * k)) & 0xFFu);
    }
  } else {
    const uint8_t* src = in + img + (size_t)p0 * 3;
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        px[i][c] = (float)(int)src[3 * min(i, n - 1) + c];
  }
  noisy_pixels<kPix, false>(p, ys, xs, px, o);
  if (whole) {
    float4* q = quads[warp] + 3 * lane;
    q[0] = make_float4(o[0][0], o[0][1], o[0][2], o[1][0]);
    q[1] = make_float4(o[1][1], o[1][2], o[2][0], o[2][1]);
    q[2] = make_float4(o[2][2], o[3][0], o[3][1], o[3][2]);
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(out + img + (size_t)wp0 * 3);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dst[lane + 32 * j] = quads[warp][lane + 32 * j];
  } else {
    float* dst = out + img + (size_t)p0 * 3;
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (i < n)
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[3 * i + c] = o[i][c];
  }
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
  // whole words and float4s where every image starts aligned
  const int vec = (h * w) % kPix == 0 && (uintptr_t)in % 4 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const dim3 grid((h * w + kBlockPix - 1) / kBlockPix, b);
  mix_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, (const int*)kind, (const float*)level,
      (const int*)seeds, (const float*)vals, (const float*)centers,
      (const float*)bloom, (const float*)rows, (const float*)off, h, w, vec);
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
