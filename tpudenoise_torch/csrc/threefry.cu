// Threefry-2x32 random fields for Hopper (sm_90a), bit-equal to jax.random.
//
// Replaces no Pallas kernel: it is the draw that XLA fuses into the noise
// generators of tpudenoise/noise/generators.py and fast_samplers.py
// (jax.random.bits / uniform / normal under jax_threefry_partitionable).
// Element i of key b is threefry2x32(key_b, (hi, lo) of i) with 20 rounds,
// then bits_hi ^ bits_lo (jax's _threefry_random_bits_partitionable).
//
// Modes:
//   0 bits:    the 32-bit word, stored as int32;
//   1 uniform: 23 mantissa bits under the exponent of 1.0, minus 1, then
//              max(lo, fma(u, span, lo)) -- XLA's CPU code contracts the
//              scale and shift of jax.random.uniform into one FMA;
//   2 normal:  jax's _normal_real: u uniform in [nextafter(-1, 0), 1),
//              scale * erf_inv(u) with XLA's f32 erf_inv (Giles'
//              polynomial): w = -log1p(-u*u), Horner steps as FMAs.
//              scale is f32(sqrt(2)) for N(0, 1); XLA folds a constant
//              factor applied to the draw into it (sqrt(2) * sd), and
//              scale 1 gives the bare erf_inv for callers that contract
//              the factor into an FMA themselves.
//
// What bounds it on this card: issued integer instructions.  A word is 20
// rounds of add, rotate and xor plus 10 key-injection adds, ~75 32-bit
// operations against 4 bytes written.  The card issues one warp
// instruction a clock per SM quarter, but runs the rotates (SHF) and xors
// (LOP3) on the 16-lane integer pipe, at half that rate: with the adds
// there too (IADD3) that pipe, not the issue slot, is the limit.  So:
//   * the adds multiply by kOne, a 1 that ptxas cannot see, and issue as
//     IMAD on the FMA pipe; the integer pipe keeps the rotates and xors,
//     about half of the instructions, and issue and that pipe balance;
//   * each thread takes 8 consecutive counters: one key load, key
//     schedule and index computation for eight words, eight independent
//     round chains in flight, and 16-byte stores where the row allows
//     them (scalar stores at a row's end and for rows not 16-byte
//     aligned).  On the H100, 8 ran 3-5% faster than 4, and 2 slower;
//   * a normal's erf_inv branches on w < 5 (nearly every word) instead of
//     selecting each Horner coefficient.
// Nothing is read but the key; stores are coalesced across the warp.
//
// Built with --fmad=false: the only fused multiply-adds are the explicit
// __fmaf_rn calls, placed where XLA's CPU code contracts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;       // consecutive counters a thread
static_assert(kWords % 4 == 0, "16-byte stores of whole groups of 4");

// 1, in constant memory so that ptxas cannot fold it: a * kOne + b is an
// IMAD (FMA pipe) where a + b would be an IADD3 (integer pipe)
__constant__ uint32_t kOne = 1u;

__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b) {
  return a * kOne + b;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry2x32 of the counters (0, i0 + j), j < kWords: bits_hi ^ bits_lo
__device__ __forceinline__ void threefry_words(uint32_t k0, uint32_t k1,
                                               uint32_t i0,
                                               uint32_t (&w)[kWords]) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0[kWords], x1[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    x0[j] = ks[0];                 // counter hi word 0
    x1[j] = (i0 + j) + ks[1];
  }
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        x0[j] = add_fma(x0[j], x1[j]);
        x1[j] = rotl(x1[j], rot[step % 2][r]) ^ x0[j];
      }
    }
    const uint32_t inj1 = ks[(step + 2) % 3] + (uint32_t)(step + 1);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      x0[j] = add_fma(x0[j], ks[(step + 1) % 3]);
      x1[j] = add_fma(x1[j], inj1);
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = x0[j] ^ x1[j];
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's f32 erf_inv; each branch runs the Horner steps of its
// coefficients (w < 5: |x| < ~0.9966)
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-(x * x));
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int* __restrict__ keys, uint32_t* __restrict__ out,
                int n, float lo, float span, float scale) {
  const int b = blockIdx.y;
  // unsigned: the last block's counters may pass 2^31 (n < 2^31)
  const uint32_t i0 = (blockIdx.x * kThreads + threadIdx.x) * kWords;
  if (i0 >= (uint32_t)n) return;
  uint32_t v[kWords];
  threefry_words((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1], i0, v);
  if (MODE != 0) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      float u = fmaxf(lo, __fmaf_rn(unit_float(v[j]), span, lo));
      if (MODE == 2) u = scale * erf_inv(u);
      v[j] = __float_as_uint(u);
    }
  }
  const size_t e = (size_t)b * n + i0;
  if (i0 + kWords <= (uint32_t)n && (e & 3) == 0) {
#pragma unroll
    for (int j = 0; j < kWords; j += 4)
      *reinterpret_cast<uint4*>(out + e + j) =
          make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    if (i0 + j < (uint32_t)n) out[e + j] = v[j];
}

}  // namespace

extern "C" {

// keys: (k, 2) int32 key words; out: (k, n) int32 (mode 0) or float32.
// For mode 2, lo and span must be nextafter(-1, 0) and its f32 span (2).
int threefry_draw(const void* keys, void* out, int k, int n, int mode,
                  float lo, float span, float scale, void* stream) {
  const int per_block = kThreads * kWords;
  const dim3 grid((n - 1) / per_block + 1, k);   // n >= 1
  const cudaStream_t s = (cudaStream_t)stream;
  const int* kw = (const int*)keys;
  uint32_t* o = (uint32_t*)out;
  if (mode == 0)
    threefry_kernel<0><<<grid, kThreads, 0, s>>>(kw, o, n, lo, span, scale);
  else if (mode == 1)
    threefry_kernel<1><<<grid, kThreads, 0, s>>>(kw, o, n, lo, span, scale);
  else
    threefry_kernel<2><<<grid, kThreads, 0, s>>>(kw, o, n, lo, span, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
