// Standalone bilateral filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudenoise/denoise/pallas_bilateral.py:
// _bilateral_kernel / bilateral_pallas: cv2.bilateralFilter(d=9,
// sigmaColor=20, sigmaSpace=100, BORDER_CONSTANT) over a batch of
// (B, H, W, 3) float32 u8-domain images, one pass per call.
//
// Layout: each block filters a 16 x 64 pixel tile of one image
// (blockIdx.z).  It stages the tile and its 4-pixel halo planar in shared
// memory, [3][24][72] floats (20.7 KB), zero outside the image (the
// BORDER_CONSTANT border takes part in the sums); then each of its 256
// threads filters 4 pixels with bilateral_taps::pixel, which the mix +
// bilateral kernel (mix_noise.cu) shares.  The TPU kernel moves planar
// tiles by DMA; here the window load is a plain strided read that the
// halo makes ~1.7x the tile.
//
// What bounds it on this card: arithmetic.  Each pixel runs 49 taps of
// ~20 float operations and one expf (~1 k operations); it reads and writes
// 12 bytes.  At 8 x 600 x 1000 that is ~4.7 G operations (~70 us at 67
// TFLOP/s of f32 outside the tensor cores) against 115 MB (~34 us at 3.35
// TB/s).  This first version is simple: scalar loads, no TMA.
//
// Built with --fmad=false and no fast math: bit-exact against the plain
// torch version (denoise/bilateral.py:bilateral_plain).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bilateral_taps.cuh"

namespace {

using bilateral_taps::kRadius;
using bilateral_taps::kTaps;
constexpr int kTileH = 16, kTileW = 64;
constexpr int kWinH = kTileH + 2 * kRadius, kWinW = kTileW + 2 * kRadius;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ sw_g, float gc, int h, int w) {
  __shared__ float win[3][kWinH][kWinW];
  __shared__ float sw[kTaps];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  if (threadIdx.x < kTaps) sw[threadIdx.x] = sw_g[threadIdx.x];
  for (int i = threadIdx.x; i < kWinH * kWinW; i += blockDim.x) {
    const int wy = i / kWinW, wx = i % kWinW;
    const int y = r0 - kRadius + wy, x = c0 - kRadius + wx;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const size_t e = (((size_t)b * h + y) * w + x) * 3;
    for (int c = 0; c < 3; ++c) win[c][wy][wx] = inside ? in[e + c] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    const int ty = i / kTileW, tx = i % kTileW;
    const int y = r0 + ty, x = c0 + tx;
    if (y >= h || x >= w) continue;
    float o[3];
    bilateral_taps::pixel<kWinH, kWinW>(win, ty + kRadius, tx + kRadius, sw,
                                        gc, o);
    const size_t e = (((size_t)b * h + y) * w + x) * 3;
    for (int c = 0; c < 3; ++c) out[e + c] = o[c];
  }
}

}  // namespace

extern "C" {

// in, out: (b, h, w, 3) float32; sw: the 49 spatial weights in tap order;
// gc: -0.5 / sigma_color^2 as f32.
int bilateral(const void* in, void* out, const void* sw, float gc, int b,
              int h, int w, void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  bilateral_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)sw, gc, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
