// Sun-flare ("bloom") compositing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudenoise/noise/pallas_bloom.py
// (_bloom_kernel / bloom_pallas): 48 overlay/output steps per pixel
// (bloom_steps.cuh, shared with the bloom kind of mix_noise.cu).
//
// Batched: images (B, H, W, 3) u8 or f32 u8-domain, params (B, 48, 8)
// f32, output f32.  A block is 64 x 4 threads over 4 rows of 1024 pixels
// of one image; a thread takes 4 neighbouring pixels of a row (all three
// channels).  The image's 384 params sit in shared memory.
//
// What bounds it on this card: issued instructions.  The plain version
// counts ~430 operations an element (~1300 a pixel) against 3 bytes in and
// 12 out, so ~0.09 ms of the card's f32 rate at 8 x 600x1000 against
// ~0.02 ms of memory traffic.  What the design does about it:
//   * blocks whose image's params and pixels allow it (bloom_steps.cuh:
//     composite_fast; always, for u8 images and bloom_params' params)
//     round with two adds on the FMA pipe instead of rintf, skip the clamp
//     and the NaN test, and skip the blends of steps 0-7, which step 8's
//     alpha of 1 overwrites; any other block runs the general form in the
//     same launch, with the same bits;
//   * 4 pixels a thread: each step's params are read once, as two 16-byte
//     shared loads, for 4 pixels, and the row term of each circle test is
//     computed once; u8 pixels are read as three 32-bit words, f32 pixels
//     and the output as three float4, where the row allows it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bloom_steps.cuh"

namespace {

constexpr int kPix = 4;               // pixels a thread, along a row
constexpr int kTx = 64, kTy = 4;      // threads a block: columns x rows
constexpr int kThreads = kTx * kTy;
constexpr int kBlockW = kTx * kPix;   // pixels a block row

// the kPix pixels at element e (= 3 * pixel index) of a row with `left`
// pixels from them to its end; vector loads where the pixels fill whole
// aligned words
__device__ __forceinline__ void load_pixels(const uint8_t* in, size_t e,
                                            int left, bool vec,
                                            float (&px)[kPix][3]) {
  if (vec) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(in + e);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t word = p[k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        px[(4 * k + j) / 3][(4 * k + j) % 3] =
            (float)((word >> (8 * j)) & 0xFFu);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 3 * kPix; ++i)
    px[i / 3][i % 3] = i < 3 * left ? (float)(int)in[e + i] : 0.0f;
}

__device__ __forceinline__ void load_pixels(const float* in, size_t e,
                                            int left, bool vec,
                                            float (&px)[kPix][3]) {
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(in + e);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 v = p[k];
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) px[(4 * k + j) / 3][(4 * k + j) % 3] = f[j];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 3 * kPix; ++i)
    px[i / 3][i % 3] = i < 3 * left ? in[e + i] : 0.0f;
}

__device__ __forceinline__ bool pixels_in_range(const uint8_t*,
                                                const float (&)[kPix][3]) {
  return true;
}
__device__ __forceinline__ bool pixels_in_range(const float*,
                                                const float (&px)[kPix][3]) {
  bool ok = true;
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) ok = ok && bloom_steps::in_u8_range(px[p][c]);
  return ok;
}

// u8 pixels load as 32-bit words, f32 ones and the output as float4
__device__ __forceinline__ bool aligned(const uint8_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}
__device__ __forceinline__ bool aligned(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bloom_kernel(const T* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ params, int h, int w) {
  __shared__ float4 prm4[bloom_steps::kSteps * 2];
  float* prm = reinterpret_cast<float*>(prm4);
  const int b = blockIdx.z;
  const int y = blockIdx.y * kTy + threadIdx.y;
  const int x0 = blockIdx.x * kBlockW + threadIdx.x * kPix;
  const int left = min(w - x0, kPix);
  const bool live = y < h && left > 0;
  const size_t e = (((size_t)b * h + y) * w + x0) * 3;
  // whole pixels at aligned addresses (every thread, where w % 4 == 0)
  const bool vec = left == kPix && aligned(in + e) && aligned(out + e);
  float px[kPix][3];
  if (live) load_pixels(in, e, left, vec, px);
  const float* src = params + (size_t)b * bloom_steps::kSteps * 8;
  for (int j = threadIdx.y * kTx + threadIdx.x; j < bloom_steps::kSteps * 8;
       j += kThreads)
    prm[j] = src[j];
  // (its barrier also publishes prm)
  const bool fast =
      bloom_steps::block_fast(src, !live || pixels_in_range(in, px));
  if (!live) return;
  if (fast) {
    float xx[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) xx[p] = (float)(x0 + p);
    bloom_steps::composite_fast<kPix>(prm4, xx, (float)y, px);
  } else {
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (p >= left) break;
      float o[3];
      bloom_steps::composite(prm, (float)(x0 + p), (float)y, px[p], o);
      for (int c = 0; c < 3; ++c) px[p][c] = o[c];
    }
  }
  if (vec) {
    float4* o = reinterpret_cast<float4*>(out + e);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[k] = make_float4(px[(4 * k) / 3][(4 * k) % 3],
                         px[(4 * k + 1) / 3][(4 * k + 1) % 3],
                         px[(4 * k + 2) / 3][(4 * k + 2) % 3],
                         px[(4 * k + 3) / 3][(4 * k + 3) % 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 3 * kPix; ++i)
    if (i < 3 * left) out[e + i] = px[i / 3][i % 3];
}

dim3 grid_for(int b, int h, int w) {
  return dim3((w + kBlockW - 1) / kBlockW, (h + kTy - 1) / kTy, b);
}

}  // namespace

extern "C" {

int bloom_u8(const void* in, void* out, const void* params, int b, int h,
             int w, void* stream) {
  bloom_kernel<uint8_t><<<grid_for(b, h, w), dim3(kTx, kTy), 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, (const float*)params, h, w);
  return (int)cudaGetLastError();
}

int bloom_f32(const void* in, void* out, const void* params, int b, int h,
              int w, void* stream) {
  bloom_kernel<float><<<grid_for(b, h, w), dim3(kTx, kTy), 0,
                        (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)params, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
