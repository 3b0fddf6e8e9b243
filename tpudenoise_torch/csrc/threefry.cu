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
// What bounds it on this card: integer operations.  Each word costs ~78
// 32-bit ops (20 add/rotate/xor rounds, 5 key injections) against 4 bytes
// written, ~20 ops per byte, so a field of 14.4M words (8 images of
// 600x1000x3) is ~1.1 G ops, ~17 us at the card's 67 T non-tensor op/s
// against ~17 us for its 58 MB of stores.  One thread per word, stores
// coalesced across the warp; nothing is read but the key.
//
// Built with --fmad=false: the only fused multiply-adds are the explicit
// __fmaf_rn calls, placed where XLA's CPU code contracts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t c_hi,
                                                  uint32_t c_lo) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c_hi + ks[0], x1 = c_lo + ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[step % 2][r]) ^ x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + (uint32_t)(step + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__constant__ float kLt[9] = {2.81022636e-08f,  3.43273939e-07f,
                             -3.5233877e-06f,  -4.39150654e-06f,
                             0.00021858087f,   -0.00125372503f,
                             -0.00417768164f,  0.246640727f,
                             1.50140941f};
__constant__ float kGt[9] = {-0.000200214257f, 0.000100950558f,
                             0.00134934322f,   -0.00367342844f,
                             0.00573950773f,   -0.0076224613f,
                             0.00943887047f,   1.00167406f,
                             2.83297682f};

__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-(x * x));
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? kLt[0] : kGt[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? kLt[i] : kGt[i]);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int* __restrict__ keys, void* __restrict__ out, int n,
                int mode, float lo, float span, float scale) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t bits = threefry_word((uint32_t)keys[2 * b],
                                      (uint32_t)keys[2 * b + 1], 0u,
                                      (uint32_t)i);
  const size_t e = (size_t)b * n + i;
  if (mode == 0) {
    ((int*)out)[e] = (int)bits;
    return;
  }
  const float u = fmaxf(lo, __fmaf_rn(unit_float(bits), span, lo));
  if (mode == 1) {
    ((float*)out)[e] = u;
    return;
  }
  ((float*)out)[e] = scale * erf_inv(u);
}

}  // namespace

extern "C" {

// keys: (k, 2) int32 key words; out: (k, n) int32 (mode 0) or float32.
// For mode 2, lo and span must be nextafter(-1, 0) and its f32 span (2).
int threefry_draw(const void* keys, void* out, int k, int n, int mode,
                  float lo, float span, float scale, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, k);
  threefry_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, out, n, mode, lo, span, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
