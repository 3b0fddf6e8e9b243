// Sun-flare ("bloom") compositing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudenoise/noise/pallas_bloom.py
// (_bloom_kernel / bloom_pallas): 48 overlay/output steps per pixel
// (bloom_steps.cuh, shared with the bloom kind of mix_noise.cu).
//
// Batched: images (B, H, W, 3) u8 or f32 u8-domain, params (B, 48, 8)
// f32, output f32.  One thread per pixel (all three channels); the block's
// image's 384 params sit in shared memory.
//
// What bounds it on this card: arithmetic.  A pixel costs 3-4 flops per
// circle mask and ~6 per channel per step, ~1200 flops against 3 bytes in
// and 12 out; at 8 x 600x1000 that is ~6 GFLOP, some 0.1 ms of the card's
// f32 rate, against ~0.04 ms of memory traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bloom_steps.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const uint8_t* p, size_t i) {
  return (float)(int)p[i];
}
__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bloom_kernel(const T* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ params, int h, int w) {
  __shared__ float prm[bloom_steps::kSteps * 8];
  const int b = blockIdx.z, y = blockIdx.y;
  for (int i = threadIdx.x; i < bloom_steps::kSteps * 8; i += blockDim.x)
    prm[i] = params[(size_t)b * bloom_steps::kSteps * 8 + i];
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t e = (((size_t)b * h + y) * w + x) * 3;
  float px[3], o[3];
  for (int c = 0; c < 3; ++c) px[c] = load_f32(in, e + c);
  bloom_steps::composite(prm, (float)x, (float)y, px, o);
  for (int c = 0; c < 3; ++c) out[e + c] = o[c];
}

dim3 grid_for(int b, int h, int w) {
  return dim3((w + kThreads - 1) / kThreads, h, b);
}

}  // namespace

extern "C" {

int bloom_u8(const void* in, void* out, const void* params, int b, int h,
             int w, void* stream) {
  bloom_kernel<uint8_t><<<grid_for(b, h, w), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, (const float*)params, h, w);
  return (int)cudaGetLastError();
}

int bloom_f32(const void* in, void* out, const void* params, int b, int h,
              int w, void* stream) {
  bloom_kernel<float><<<grid_for(b, h, w), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)params, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
