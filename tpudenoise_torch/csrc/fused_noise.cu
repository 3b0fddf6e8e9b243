// Fused noise + 3x3 denoise in one device-memory pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpudenoise/noise/pallas_kernels.py:
//   * sap_median_*  <- _fused_batched_kernel / fused_sap_median_batched
//     (salt & pepper from a coordinate hash, then 3x3 median x1 or x2,
//     BORDER_REPLICATE; the second median re-pads from the FILTERED rows);
//   * gauss_blur_*  <- _fused_gauss_batched_kernel / fused_gaussian_blur
//     (Box-Muller N(0, sigma^2) from two coordinate hashes, u8 truncation,
//     then the [1,2,1]/4 separable blur x1 or x2 with REFLECT_101; halo rows
//     draw the mirrored row's noise; the second blur re-pads from the
//     blurred rows).
//
// Images are (B, H, W, 3) u8 or f32 u8-domain, viewed as an interleaved
// (H, W*3) raster per image: lane x = 3*pixel + channel, so a pixel's
// horizontal neighbours are lanes x-3 and x+3.
//
// What bounds it on this card: device-memory bytes.  The work per element
// is a hash and ~30 min/max or ~20 flops, far below the H100's ratio of
// arithmetic to bandwidth, so the floor is one u8 read and one u8 write per
// element (2 bytes; 28.8 MB for a (8, 600, 1000, 3) batch, ~9 us at
// 3.35 TB/s).  The design keeps every intermediate (noisy raster, first
// filter pass) in shared memory: one block owns a 16-row x 256-lane output
// tile, stages its noisy window with a 2-row / 6-lane halo, computes the
// first pass on a 1-row / 3-lane halo and writes only the final pass.  The
// halo re-reads (~1.3x of the input) hit L2.  No TMA or async copies yet.
//
// Numerics: built with --fmad=false and without fast math, so every float
// operation rounds where the reference's XLA CPU code rounds; the order of
// operations below follows pallas_kernels.py term by term.  Only logf/cosf
// may differ from XLA's by an ulp, which can move a truncated u8 by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // output rows per block
constexpr int kLanes = 256;   // output lanes per block
constexpr int kHalo = 6;      // lanes each side: two stencils x 3 lanes
constexpr int kThreads = 256;
constexpr int kNoisyW = kLanes + 2 * kHalo;   // lanes c0-6 .. c0+kLanes+5
constexpr int kMidW = kLanes + kHalo;         // lanes c0-3 .. c0+kLanes+2

__device__ __forceinline__ uint32_t hash2d(uint32_t iy, uint32_t ix,
                                           uint32_t seed) {
  uint32_t h = (iy * 0x9E3779B9u) ^ (ix * 0x85EBCA6Bu) ^ (seed * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float load_f32(const uint8_t* p, size_t i) {
  return (float)(int)p[i];
}
__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ void store(uint8_t* p, size_t i, float v) {
  p[i] = (uint8_t)(int)v;
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}

// ------------------------------------------------------------ median ----

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

__device__ __forceinline__ void sort3(float a, float b, float c, float& lo,
                                      float& mid, float& hi) {
  float l = fminf(a, b);
  float h = fmaxf(a, b);
  float m = fminf(h, c);
  hi = fmaxf(h, c);
  lo = fminf(l, m);
  mid = fmaxf(l, m);
}

// 3x3 median around tile row ty, lanes (tl, tc, tr): the column-sort form
// of _median3_tile (exact median of the 9 values).
template <int W>
__device__ __forceinline__ float median9(const float (*t)[W], int ty, int tl,
                                         int tc, int tr) {
  float lo_l, mid_l, hi_l, lo_c, mid_c, hi_c, lo_r, mid_r, hi_r;
  sort3(t[ty - 1][tl], t[ty][tl], t[ty + 1][tl], lo_l, mid_l, hi_l);
  sort3(t[ty - 1][tc], t[ty][tc], t[ty + 1][tc], lo_c, mid_c, hi_c);
  sort3(t[ty - 1][tr], t[ty][tr], t[ty + 1][tr], lo_r, mid_r, hi_r);
  float maxlo = fmaxf(fmaxf(lo_l, lo_c), lo_r);
  float minhi = fminf(fminf(hi_l, hi_c), hi_r);
  return med3(maxlo, med3(mid_l, mid_c, mid_r), minhi);
}

// BORDER_REPLICATE neighbour lanes: the same channel of the clamped pixel.
__device__ __forceinline__ int left_replicate(int x) { return x >= 3 ? x - 3 : x; }
__device__ __forceinline__ int right_replicate(int x, int w3) {
  return x < w3 - 3 ? x + 3 : x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sap_median_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds, int h, int w3,
                  uint32_t thresh, int double_filter) {
  // tile row of global row g: g - (r0 - 2) in noisy, g - (r0 - 1) in mid;
  // a stored row holds the value of the CLAMPED row (replicate border)
  __shared__ float noisy[kRows + 4][kNoisyW];
  __shared__ float mid[kRows + 2][kMidW];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kLanes;
  const uint32_t seed = (uint32_t)seeds[b];
  const size_t base = (size_t)b * h * w3;

  for (int i = threadIdx.x; i < (kRows + 4) * kNoisyW; i += blockDim.x) {
    const int ty = i / kNoisyW, tx = i % kNoisyW;
    const int y = min(max(r0 - 2 + ty, 0), h - 1);
    const int x = min(max(c0 - kHalo + tx, 0), w3 - 1);
    const uint32_t bits = hash2d((uint32_t)y, (uint32_t)x, seed);
    float v = load_f32(in, base + (size_t)y * w3 + x);
    if (bits < thresh) v = (bits & 1u) ? 255.0f : 0.0f;
    noisy[ty][tx] = v;
  }
  __syncthreads();

  // first median at rows r0-1 .. r0+kRows; row -1 / h hold the filtered
  // rows 0 / h-1 (cv2 re-pads the filtered image before the second pass)
  for (int i = threadIdx.x; i < (kRows + 2) * kMidW; i += blockDim.x) {
    const int my = i / kMidW, mx = i % kMidW;
    const int x = c0 - 3 + mx;
    if (x < 0 || x >= w3) continue;  // never read: neighbours stay in-image
    const int yc = min(max(r0 - 1 + my, 0), h - 1);
    const int ty = yc - (r0 - 2);
    const int o = kHalo - c0;
    mid[my][mx] = median9<kNoisyW>(noisy, ty, left_replicate(x) + o, x + o,
                                   right_replicate(x, w3) + o);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kLanes; i += blockDim.x) {
    const int y = r0 + i / kLanes, x = c0 + i % kLanes;
    if (y >= h || x >= w3) continue;
    const int my = y - (r0 - 1);
    const int o = 3 - c0;
    const float v = double_filter
        ? median9<kMidW>(mid, my, left_replicate(x) + o, x + o,
                         right_replicate(x, w3) + o)
        : mid[my][x + o];
    store(out, base + (size_t)y * w3 + x, v);
  }
}

// ------------------------------------------------------ gaussian blur ----

__device__ __forceinline__ int reflect101(int y, int n) {
  if (y < 0) y = -y;
  if (y > n - 1) y = 2 * (n - 1) - y;
  return min(max(y, 0), n - 1);  // rows this far out feed no output
}

__device__ __forceinline__ float u01(uint32_t bits) {
  // 31 bits through int32, as _u01 (Mosaic has no uint32 -> f32 cast)
  return (float)(int)(bits >> 1) * (1.0f / 2147483648.0f);
}

__device__ __forceinline__ float gauss_from_hash(uint32_t iy, uint32_t ix,
                                                 uint32_t seed, float sigma) {
  const float kTiny = (float)1e-12;
  const float kTwoPi = (float)(2.0 * 3.14159265358979);
  const float u1 = fmaxf(u01(hash2d(iy, ix, seed)), kTiny);
  // seed + 0x2545F491 with int32 wraparound == the uint32 sum
  const float u2 = u01(hash2d(iy, ix, seed + 0x2545F491u));
  const float r = sqrtf(-2.0f * logf(u1));
  return sigma * r * cosf(kTwoPi * u2);
}

// [1,2,1]/4 vertical tap at tile row ty, lane tx: (0.25a + 0.5b) + 0.25c
template <int W>
__device__ __forceinline__ float vtap(const float (*t)[W], int ty, int tx) {
  return (0.25f * t[ty - 1][tx] + 0.5f * t[ty][tx]) + 0.25f * t[ty + 1][tx];
}

// horizontal tap with REFLECT_101 at the true x edges, then half-up round
template <int W>
__device__ __forceinline__ float blur9(const float (*t)[W], int ty, int x,
                                       int w3, int o) {
  const float v = vtap<W>(t, ty, x + o);
  const float left = x >= 3 ? vtap<W>(t, ty, x - 3 + o)
                            : vtap<W>(t, ty, x + 3 + o);
  const float right = x < w3 - 3 ? vtap<W>(t, ty, x + 3 + o) : left;
  return floorf(((0.25f * left + 0.5f * v) + 0.25f * right) + 0.5f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gauss_blur_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds,
                  const float* __restrict__ sigmas, int h, int w3,
                  int apply_noise, int double_filter) {
  // a stored row holds the value of the REFLECTED row (REFLECT_101)
  __shared__ float noisy[kRows + 4][kNoisyW];
  __shared__ float mid[kRows + 2][kMidW];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kLanes;
  const uint32_t seed = (uint32_t)seeds[b];
  const float sigma = sigmas[b];
  const size_t base = (size_t)b * h * w3;
  const float kInv255 = (float)(1.0 / 255.0);

  for (int i = threadIdx.x; i < (kRows + 4) * kNoisyW; i += blockDim.x) {
    const int ty = i / kNoisyW, tx = i % kNoisyW;
    const int y = reflect101(r0 - 2 + ty, h);
    const int x = min(max(c0 - kHalo + tx, 0), w3 - 1);
    float v = load_f32(in, base + (size_t)y * w3 + x);
    if (apply_noise) {
      const float z = gauss_from_hash((uint32_t)y, (uint32_t)x, seed, sigma);
      const float x01 = v * kInv255 + z;
      v = truncf(fminf(fmaxf(x01, 0.0f), 1.0f) * 255.0f);
    }
    noisy[ty][tx] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (kRows + 2) * kMidW; i += blockDim.x) {
    const int my = i / kMidW, mx = i % kMidW;
    const int y = r0 - 1 + my;
    const int x = c0 - 3 + mx;
    if (x < 0 || x >= w3 || y > h) continue;  // feeds no output
    const int yr = reflect101(y, h);
    mid[my][mx] = blur9<kNoisyW>(noisy, yr - (r0 - 2), x, w3, kHalo - c0);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kLanes; i += blockDim.x) {
    const int y = r0 + i / kLanes, x = c0 + i % kLanes;
    if (y >= h || x >= w3) continue;
    const int my = y - (r0 - 1);
    const float v = double_filter ? blur9<kMidW>(mid, my, x, w3, 3 - c0)
                                  : mid[my][x + 3 - c0];
    store(out, base + (size_t)y * w3 + x, v);
  }
}

dim3 grid_for(int b, int h, int w3) {
  return dim3((w3 + kLanes - 1) / kLanes, (h + kRows - 1) / kRows, b);
}

}  // namespace

extern "C" {

int sap_median_u8(const void* in, void* out, const void* seeds, int b, int h,
                  int w3, int thresh, int double_filter, void* stream) {
  sap_median_kernel<uint8_t><<<grid_for(b, h, w3), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int*)seeds, h, w3,
      (uint32_t)thresh, double_filter);
  return (int)cudaGetLastError();
}

int sap_median_f32(const void* in, void* out, const void* seeds, int b, int h,
                   int w3, int thresh, int double_filter, void* stream) {
  sap_median_kernel<float><<<grid_for(b, h, w3), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const int*)seeds, h, w3,
      (uint32_t)thresh, double_filter);
  return (int)cudaGetLastError();
}

int gauss_blur_u8(const void* in, void* out, const void* seeds,
                  const void* sigmas, int b, int h, int w3, int apply_noise,
                  int double_filter, void* stream) {
  gauss_blur_kernel<uint8_t><<<grid_for(b, h, w3), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int*)seeds,
      (const float*)sigmas, h, w3, apply_noise, double_filter);
  return (int)cudaGetLastError();
}

int gauss_blur_f32(const void* in, void* out, const void* seeds,
                   const void* sigmas, int b, int h, int w3, int apply_noise,
                   int double_filter, void* stream) {
  gauss_blur_kernel<float><<<grid_for(b, h, w3), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const int*)seeds, (const float*)sigmas,
      h, w3, apply_noise, double_filter);
  return (int)cudaGetLastError();
}

}  // extern "C"
