// Standalone bilateral filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudenoise/denoise/pallas_bilateral.py:
// _bilateral_kernel / bilateral_pallas: cv2.bilateralFilter(d=9,
// sigmaColor=20, sigmaSpace=100, BORDER_CONSTANT) over a batch of
// (B, H, W, 3) float32 images, one pass per call.
//
// Layout: each block filters a 32 x 32 pixel tile of one image
// (blockIdx.z).  It stages the tile and its 4-pixel halo in dynamic
// shared memory (bilateral_taps::stage: three float planes and the packed
// bytes), zero outside the image (the BORDER_CONSTANT border takes part in
// the sums), with the 766-entry colour-weight table beside it (28,664
// bytes, under the 48 KB a launch gets without opting in); then its
// threads filter strips of 2 pixels of one column each
// (bilateral_taps::filter_tile, which the mix + bilateral kernel in
// mix_noise.cu shares).
//
// What bounds it on this card: issued instructions.  Each pixel runs 49
// taps.  One expf (~10 instructions at --fmad=false), three shared loads
// and ~13 float operations a tap is the plain form.  A block whose
// window holds only u8 values (u8 input, every noise kind that ends in a
// u8 cast or rounding, every second bilateral pass) instead takes d with
// one byte-wise SAD of packed words and the colour weight from the
// table, bit-exact; a strip reuses each loaded window value from a
// register.  A block with any other value (the gaussian kind's [0, 1]
// floats) keeps the per-tap expf.  The halo costs only loads here.
//
// Built with --fmad=false and no fast math: bit-exact against the plain
// torch version (denoise/bilateral.py:bilateral_plain).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "bilateral_taps.cuh"

namespace {

using bilateral_taps::kRadius;
using bilateral_taps::Weights;
constexpr int kTileH = 32, kTileW = 32, kStrip = 2;
constexpr int kWinH = kTileH + 2 * kRadius, kWinW = kTileW + 2 * kRadius;
constexpr int kThreads = 256;
constexpr int kSmem = bilateral_taps::smem_bytes(kWinH, kWinW);
static_assert(kSmem <= 48 * 1024, "no opt-in to more shared memory");

__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const __grid_constant__ Weights sw, float gc, int h, int w) {
  extern __shared__ float smem[];
  auto win = reinterpret_cast<float (*)[kWinH][kWinW]>(smem);
  float* lut = smem + 4 * kWinH * kWinW;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  bilateral_taps::fill_lut(lut, gc);
  bool u8 = true;
  for (int i = threadIdx.x; i < kWinH * kWinW; i += blockDim.x) {
    const int wy = i / kWinW, wx = i % kWinW;
    const int y = r0 - kRadius + wy, x = c0 - kRadius + wx;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const size_t e = (((size_t)b * h + y) * w + x) * 3;
    float v[3];
    for (int c = 0; c < 3; ++c) v[c] = inside ? in[e + c] : 0.0f;
    u8 = u8 & bilateral_taps::stage(win, wy, wx, v);
  }
  const bool table = __syncthreads_and(u8);
  bilateral_taps::filter_tile<kTileH, kTileW, kStrip, kWinH, kWinW>(
      win, table, sw, gc, lut, out, b, h, w, r0, c0);
}

}  // namespace

extern "C" {

// in, out: (b, h, w, 3) float32 on the device; sw: HOST pointer to the 49
// spatial weights in tap order (they go to the kernel as a parameter);
// gc: -0.5 / sigma_color^2 as f32.
int bilateral(const void* in, void* out, const void* sw, float gc, int b,
              int h, int w, void* stream) {
  Weights wt;
  memcpy(wt.v, sw, sizeof(wt.v));
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  bilateral_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, wt, gc, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
