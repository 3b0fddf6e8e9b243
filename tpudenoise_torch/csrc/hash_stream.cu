// The counter-hash stream of --fast-rng for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the XLA code of
// tpudenoise/noise/fast_samplers.py:62-104 (_hash_words, _u01, _normal),
// which the generators and samplers draw from when fast_bits is set.
// Element i of image b is a splitmix-style avalanche of (i, salt, seed):
//   h = i * 0x9E3779B9 ^ salt * 0x85EBCA6B ^ seed0 * 0xC2B2AE35
//   h ^= h >> 16;  h *= 0x7FEB352D;  h ^= seed1 * 0x27D4EB2F
//   h ^= h >> 15;  h *= 0x846CA68B;  h ^= h >> 16
// in wrapping u32 arithmetic, i the element's flat index within its own
// image (as under the reference's vmap) and (seed0, seed1) the image's key
// words [0] and [-1].
//
// Modes:
//   0 bits:   the word, stored as int32;
//   1 u01:    (h >> 8) as f32, plus 0.5, times 2^-24: in (0, 1);
//   2 normal: Box-Muller, sqrt(-2 log u1) * cos(f32(2 pi) * u2), u1 of salt
//             and u2 of salt + 1.
//
// A thread takes 4 consecutive counters and stores them as one 16-byte
// word where the row allows it.  Nothing is read: the bound is the bytes
// written (4 an element).  Built with --fmad=false and without fast math,
// so the normal's multiplies, logf and cosf round as the plain version's
// separate torch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;       // consecutive counters a thread

__device__ __forceinline__ uint32_t hash_word(uint32_t i, uint32_t salt_mix,
                                              uint32_t seed0_mix,
                                              uint32_t seed1_mix) {
  uint32_t h = (i * 0x9E3779B9u) ^ salt_mix ^ seed0_mix;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= seed1_mix;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float u01(uint32_t h) {
  // h >> 8 < 2^24 converts exactly; the + 0.5 rounds to nearest even
  return ((float)(int)(h >> 8) + 0.5f) * 5.9604644775390625e-08f;  // 2^-24
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
hash_kernel(const int* __restrict__ seeds, uint32_t* __restrict__ out,
            int n, uint32_t salt) {
  const int b = blockIdx.y;
  // unsigned: the last block's counters may pass 2^31 (n < 2^31)
  const uint32_t i0 = (blockIdx.x * kThreads + threadIdx.x) * kWords;
  if (i0 >= (uint32_t)n) return;
  const uint32_t s0 = (uint32_t)seeds[2 * b] * 0xC2B2AE35u;
  const uint32_t s1 = (uint32_t)seeds[2 * b + 1] * 0x27D4EB2Fu;
  const uint32_t salt0 = salt * 0x85EBCA6Bu;
  uint32_t v[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint32_t h = hash_word(i0 + j, salt0, s0, s1);
    if (MODE == 0) {
      v[j] = h;
    } else if (MODE == 1) {
      v[j] = __float_as_uint(u01(h));
    } else {
      const uint32_t h2 = hash_word(i0 + j, (salt + 1u) * 0x85EBCA6Bu, s0,
                                    s1);
      const float r = sqrtf(-2.0f * logf(u01(h)));
      const float c = cosf(6.2831854820251465f * u01(h2));  // f32(2 pi)
      v[j] = __float_as_uint(r * c);
    }
  }
  const size_t e = (size_t)b * n + i0;
  if (i0 + kWords <= (uint32_t)n && (e & 3) == 0) {
    *reinterpret_cast<uint4*>(out + e) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    if (i0 + j < (uint32_t)n) out[e + j] = v[j];
}

}  // namespace

extern "C" {

// seeds: (k, 2) int32 seed words; out: (k, n) int32 (mode 0) or float32.
int hash_draw(const void* seeds, void* out, int k, int n, int salt, int mode,
              void* stream) {
  const int per_block = kThreads * kWords;
  const dim3 grid((n - 1) / per_block + 1, k);   // n >= 1
  const cudaStream_t s = (cudaStream_t)stream;
  const int* sw = (const int*)seeds;
  uint32_t* o = (uint32_t*)out;
  const uint32_t salt_u = (uint32_t)salt;
  if (mode == 0)
    hash_kernel<0><<<grid, kThreads, 0, s>>>(sw, o, n, salt_u);
  else if (mode == 1)
    hash_kernel<1><<<grid, kThreads, 0, s>>>(sw, o, n, salt_u);
  else
    hash_kernel<2><<<grid, kThreads, 0, s>>>(sw, o, n, salt_u);
  return (int)cudaGetLastError();
}

}  // extern "C"
