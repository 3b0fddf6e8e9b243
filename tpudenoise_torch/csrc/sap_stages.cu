// The salt & pepper + median kernel cut into stages, for a cost breakdown,
// on a pre-padded raster; for Hopper (sm_90a).
//
// Replaces the profiling forks of kernel 1 (pallas_kernels.py
// _fused_batched_kernel):
//   * sap_stages_f32 <- benchmarks/profile_sap_breakdown.py _kernel / run,
//                       and at stage full benchmarks/profile_fused.py
//                       kernel_only
//   * sap_stages_u8  <- benchmarks/profile_sap_breakdown.py kern / _u8_run
//
// The raster is (B, hp + 8, w3p): an image of h rows and w3 = 3 W lanes,
// 4 rows above, hp - h + 4 below and w3p - w3 lanes on the right (the
// reference edge-pads them; kernel_only fills them with whatever it
// likes).  Raster row g + 4 holds global row g.  The output is (B, hp,
// w3p), every element a function of global coordinates only:
//   copy   out[g] = raster row g + 4;
//   noise  + salt & pepper from hash2d(clamp(g, 0, h-1), min(x, w3-1));
//   med1   + one 3x3 median over the noisy rows g-1 .. g+1 as the raster
//          holds them (no row clamping: the raster's own halo rows);
//   full   + a second median whose filtered rows -1 and h are replaced by
//          the filtered rows 0 and h-1 (cv2 re-pads before its second
//          pass).
// Lanes x - 3 / x + 3 replicate where x < 3 / x >= w3 - 3, pad lanes
// included.  The reference's tile height only sets hp; this kernel tiles
// as it likes and gives the same bits for every hp.
//
// What bounds it on this card: device-memory bytes for copy and noise;
// the full stage does ~67 operations an element, still below the card's
// ratio of arithmetic to bandwidth for f32 I/O.  A simple design: one
// block owns a 16-row x 256-lane output tile, stages the noisy window
// (3 rows above, 3 below, 6 lanes each side) in shared memory, computes
// the first median on a 1-row / 3-lane halo there and writes only the
// stage's output.  No TMA or async copies.
//
// Numerics: min/max and the hash are exact, so every stage is bit-exact
// against the plain version and the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sap_median.cuh"

namespace {

using namespace sap;

constexpr int kRows = 16;
constexpr int kLanes = 256;
constexpr int kThreads = 256;
constexpr int kHaloRows = 3;                   // rows above and below
constexpr int kHalo = 6;                       // lanes each side
constexpr int kNoisyH = kRows + 2 * kHaloRows;
constexpr int kNoisyW = kLanes + 2 * kHalo;    // lanes c0-6 .. c0+kLanes+5
constexpr int kMidW = kLanes + kHalo;          // lanes c0-3 .. c0+kLanes+2

enum Stage { kCopy = 0, kNoise = 1, kMed1 = 2, kFull = 3 };

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
sap_stages_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds, int h, int w3, int hp,
                  int w3p, uint32_t thresh) {
  __shared__ float noisy[S >= kMed1 ? kNoisyH : 1][kNoisyW];
  __shared__ float mid[S == kFull ? kRows + 2 : 1][kMidW];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kLanes;
  const uint32_t seed = (uint32_t)seeds[b];
  const size_t in_base = (size_t)b * (hp + 8) * w3p;
  const size_t out_base = (size_t)b * hp * w3p;

  if constexpr (S <= kNoise) {
    for (int i = threadIdx.x; i < kRows * kLanes; i += blockDim.x) {
      const int g = r0 + i / kLanes, x = c0 + i % kLanes;
      if (g >= hp || x >= w3p) continue;
      const size_t src = in_base + (size_t)(g + 4) * w3p + x;
      const size_t dst = out_base + (size_t)g * w3p + x;
      if constexpr (S == kCopy) {
        out[dst] = in[src];
      } else {
        const uint32_t bits = hash2d((uint32_t)min(max(g, 0), h - 1),
                                     (uint32_t)min(x, w3 - 1), seed);
        store(out, dst, salt_pepper(load_f32(in, src), bits, thresh));
      }
    }
    return;
  }

  // noisy window: tile row ty holds global row r0 - 3 + ty; rows outside
  // the raster are clamped into it and feed no output
  for (int i = threadIdx.x; i < kNoisyH * kNoisyW; i += blockDim.x) {
    const int ty = i / kNoisyW, tx = i % kNoisyW;
    const int g = r0 - kHaloRows + ty;
    const int x = min(max(c0 - kHalo + tx, 0), w3p - 1);
    const int rr = min(max(g + 4, 0), hp + 7);
    const uint32_t bits = hash2d((uint32_t)min(max(g, 0), h - 1),
                                 (uint32_t)min(x, w3 - 1), seed);
    noisy[ty][tx] = salt_pepper(load_f32(in, in_base + (size_t)rr * w3p + x),
                                bits, thresh);
  }
  __syncthreads();

  const int on = kHalo - c0;   // noisy lane of global lane x: x + on
  if constexpr (S == kMed1) {
    for (int i = threadIdx.x; i < kRows * kLanes; i += blockDim.x) {
      const int g = r0 + i / kLanes, x = c0 + i % kLanes;
      if (g >= hp || x >= w3p) continue;
      store(out, out_base + (size_t)g * w3p + x,
            median9<kNoisyW>(noisy, g - (r0 - kHaloRows),
                             left_replicate(x) + on, x + on,
                             right_replicate(x, w3) + on));
    }
    return;
  }

  // first median at rows r0-1 .. r0+kRows; filtered row -1 / h is the
  // filtered row 0 / h-1
  for (int i = threadIdx.x; i < (kRows + 2) * kMidW; i += blockDim.x) {
    const int my = i / kMidW, mx = i % kMidW;
    const int x = c0 - 3 + mx;
    if (x < 0 || x >= w3p) continue;  // never read
    const int r = r0 - 1 + my;
    const int rs = r == -1 ? 0 : (r == h ? h - 1 : r);
    mid[my][mx] = median9<kNoisyW>(noisy, rs - (r0 - kHaloRows),
                                   left_replicate(x) + on, x + on,
                                   right_replicate(x, w3) + on);
  }
  __syncthreads();

  const int om = 3 - c0;       // mid lane of global lane x: x + om
  for (int i = threadIdx.x; i < kRows * kLanes; i += blockDim.x) {
    const int g = r0 + i / kLanes, x = c0 + i % kLanes;
    if (g >= hp || x >= w3p) continue;
    store(out, out_base + (size_t)g * w3p + x,
          median9<kMidW>(mid, g - (r0 - 1), left_replicate(x) + om, x + om,
                         right_replicate(x, w3) + om));
  }
}

template <typename T, int S>
int launch(const void* in, void* out, const void* seeds, int b, int h, int w3,
           int hp, int w3p, int thresh, void* stream) {
  const dim3 grid((w3p + kLanes - 1) / kLanes, (hp + kRows - 1) / kRows, b);
  sap_stages_kernel<T, S><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (const int*)seeds, h, w3, hp, w3p,
      (uint32_t)thresh);
  return (int)cudaGetLastError();
}

template <typename T>
int stages(const void* in, void* out, const void* seeds, int b, int h, int w3,
           int hp, int w3p, int stage, int thresh, void* stream) {
  switch (stage) {
    case kCopy:
      return launch<T, kCopy>(in, out, seeds, b, h, w3, hp, w3p, thresh,
                              stream);
    case kNoise:
      return launch<T, kNoise>(in, out, seeds, b, h, w3, hp, w3p, thresh,
                               stream);
    case kMed1:
      return launch<T, kMed1>(in, out, seeds, b, h, w3, hp, w3p, thresh,
                              stream);
    case kFull:
      return launch<T, kFull>(in, out, seeds, b, h, w3, hp, w3p, thresh,
                              stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// stage: 0 copy, 1 noise, 2 med1, 3 full; thresh: the uint32 threshold as
// int32
int sap_stages_f32(const void* in, void* out, const void* seeds, int b, int h,
                   int w3, int hp, int w3p, int stage, int thresh,
                   void* stream) {
  return stages<float>(in, out, seeds, b, h, w3, hp, w3p, stage, thresh,
                       stream);
}

int sap_stages_u8(const void* in, void* out, const void* seeds, int b, int h,
                  int w3, int hp, int w3p, int stage, int thresh,
                  void* stream) {
  return stages<uint8_t>(in, out, seeds, b, h, w3, hp, w3p, stage, thresh,
                         stream);
}

}  // extern "C"
