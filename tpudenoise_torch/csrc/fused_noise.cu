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
// What bounds it on this card: instruction issue, not bytes.  One u8 read
// and one u8 write per element (28.8 MB for a (8, 600, 1000, 3) batch,
// ~9 us at 3.35 TB/s) are far below the work: a hash and ~30 min/max per
// element for sap + median, two hashes and IEEE logf/sqrtf/cosf for the
// gaussian.  sap_median_* keeps every intermediate in shared memory: one
// block owns a 16-row x 256-lane output tile, stages its noisy window with
// a 2-row / 6-lane halo, computes the first pass on a 1-row / 3-lane halo
// and writes only the final pass.  gauss_blur_* draws each element's noise
// once in a rolling walk down a column strip and blurs in integers where
// the values are integers (see its section below).
//
// Numerics: built with --fmad=false and without fast math, so every float
// operation rounds where the reference's XLA CPU code rounds; the order of
// operations below follows pallas_kernels.py term by term.  Only logf/cosf
// may differ from XLA's by an ulp, which can move a truncated u8 by one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sap_median.cuh"

namespace {

using namespace sap;  // hash2d, load_f32, store, median9, *_replicate

constexpr int kRows = 16;     // output rows per block
constexpr int kLanes = 256;   // output lanes per block
constexpr int kHalo = 6;      // lanes each side: two stencils x 3 lanes
constexpr int kThreads = 256;
constexpr int kNoisyW = kLanes + 2 * kHalo;   // lanes c0-6 .. c0+kLanes+5
constexpr int kMidW = kLanes + kHalo;         // lanes c0-3 .. c0+kLanes+2

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
    noisy[ty][tx] = salt_pepper(load_f32(in, base + (size_t)y * w3 + x),
                                bits, thresh);
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
//
// One block owns a strip of kGOut output lanes [c0, c0 + kGOut) and a
// segment of rows [r0, r1); its kGThreads threads own one lane each of the
// window [c0 - 6, c0 + kGOut + 6) and walk down the rows kBatch at a time.
// A thread keeps its lane's last two noisy rows and last two first-pass
// rows in registers, so each vertical tap is computed once, by the thread
// of its lane; the taps go through shared memory only for the horizontal
// neighbours at lanes +-3, two barriers a step.  Noise is drawn once per
// element of the window: at (8, 600, 1000, 3), 4 strips x 8 segments of
// 75 rows x 8 images = 256 blocks, two on each SM, draw 1.07x the output
// elements (16 x 256 tiles drew 1.31x).  On an H100, 768-thread blocks
// two to an SM and 8 rows a step ran 20% faster than 256 threads four or
// five to an SM and 4 rows a step (PERF.md, section 6): the noise's
// logf/sqrtf/cosf chains leave issue slots to other warps, and fewer
// barriers a row stall them less.
//
// Two routes, chosen per launch:
//   * integer (u8 input, or noise applied): every blur input is an integer
//     in [0, 255] (truncf after the noise; u8 values), so the reference's
//     float blur is exact and equals s = a + 2b + c per column (<= 1020)
//     and out = (s_L + 2 s_V + s_R + 8) >> 4: each partial sum of the
//     float form is a multiple of 1/16 below 256 (tests/
//     test_torch_kernel_forms.py holds the identity over every input);
//   * float (f32 input without noise): the reference's float taps in its
//     order.
// With the noise, the integer route issues 1402 instructions a thread for
// 8 rows where the float route issues 1553, and ran 10% faster on an H100
// (PERF.md, section 6).
// Row -1 of the first pass is row 1's value and row h is row h - 2's
// (REFLECT_101 of the blurred rows); the walk computes them from the
// mirrored noisy rows, in reversed order, so the float route takes its
// taps in the order row 1's (row h - 2's) would.

constexpr int kGThreads = 768;
constexpr int kGHalo = 6;                         // two taps of +-3 lanes
constexpr int kGOut = kGThreads - 2 * kGHalo;     // output lanes a block
constexpr int kBatch = 8;                         // rows a step
constexpr int kGBlocksPerSm = 2;                  // launch bounds
static_assert(2 * kBatch * kGThreads * 4 <= 48 * 1024,
              "the taps fit the static shared memory of a block");

// noisy row of walk row y in [-2, h + 1] (h >= 2): REFLECT_101, applied
// again where h == 2 (row 3 -> -1 -> 1)
__device__ __forceinline__ int reflect_row(int y, int h) {
  if (y < 0) y = -y;
  if (y > h - 1) y = 2 * (h - 1) - y;
  return y < 0 ? -y : y;
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

struct IntRoute {
  using V = int;
  static constexpr bool kSymmetric = true;
  // [1,2,1] vertical tap, times 4
  static __device__ __forceinline__ V vtap(V a, V b, V c) {
    return a + 2 * b + c;
  }
  // horizontal tap of three vertical ones and the half-up round
  static __device__ __forceinline__ V htap(V l, V v, V r) {
    return (l + 2 * v + r + 8) >> 4;
  }
};

struct FloatRoute {
  using V = float;
  static constexpr bool kSymmetric = false;
  static __device__ __forceinline__ V vtap(V a, V b, V c) {
    return (0.25f * a + 0.5f * b) + 0.25f * c;
  }
  static __device__ __forceinline__ V htap(V l, V v, V r) {
    return floorf(((0.25f * l + 0.5f * v) + 0.25f * r) + 0.5f);
  }
};

// the noisy value of element (y, x): the input, or for the integer route
// with noise the truncated u8 of input/255 + N(0, sigma^2)
template <typename R, typename T>
__device__ __forceinline__ typename R::V noisy(const T* img, int y, int x,
                                               int w3, uint32_t seed,
                                               float sigma, int apply_noise) {
  const float v = load_f32(img, (size_t)y * w3 + x);
  if constexpr (R::kSymmetric) {
    if (!apply_noise) return (int)v;
    const float kInv255 = (float)(1.0 / 255.0);
    const float z = gauss_from_hash((uint32_t)y, (uint32_t)x, seed, sigma);
    const float x01 = v * kInv255 + z;
    // truncf of a value in [0, 255], as an int
    return (int)(fminf(fmaxf(x01, 0.0f), 1.0f) * 255.0f);
  } else {
    return v;
  }
}

__device__ __forceinline__ void store_v(uint8_t* p, size_t i, int v) {
  p[i] = (uint8_t)v;
}
__device__ __forceinline__ void store_v(float* p, size_t i, int v) {
  p[i] = (float)v;
}
__device__ __forceinline__ void store_v(float* p, size_t i, float v) {
  p[i] = v;
}

template <typename T, typename R>
__global__ void __launch_bounds__(kGThreads, kGBlocksPerSm)
gauss_blur_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds,
                  const float* __restrict__ sigmas, int h, int w3,
                  int seg_rows, int apply_noise, int double_filter) {
  using V = typename R::V;
  __shared__ V tap1[kBatch][kGThreads];   // first pass: vertical taps
  __shared__ V tap2[kBatch][kGThreads];   // second pass: vertical taps
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int x = blockIdx.x * kGOut - kGHalo + t;   // this thread's lane
  const bool live = x >= 0 && x < w3;
  // first-pass lanes [c0 - 3, c0 + kGOut + 3), output lanes [c0, c0 + kGOut)
  const bool mid_lane = live && t >= 3 && t < kGThreads - 3;
  const bool out_lane = live && t >= kGHalo && t < kGThreads - kGHalo;
  // window positions of the horizontal neighbours, REFLECT_101 at the
  // image's lane edges (x < 3: lane x + 3 for both)
  const int tl = !mid_lane ? t : x >= 3 ? t - 3 : t + 3;
  const int tr = !mid_lane ? t : x < w3 - 3 ? t + 3 : tl;
  const int r0 = blockIdx.y * seg_rows;
  const int r1 = min(r0 + seg_rows, h);
  const uint32_t seed = (uint32_t)seeds[b];
  const float sigma = sigmas[b];
  const T* img = in + (size_t)b * h * w3;
  T* dst = out + (size_t)b * h * w3;

  // walk rows j: noisy row j, first-pass row j - 1, output row j - 2 (one
  // blur: output row j - 1); rows before the segment's fill the registers
  const int first = r0 - (double_filter ? 2 : 1);
  const int last = r1 + (double_filter ? 1 : 0);
  V n0 = 0, n1 = 0;   // noisy rows j - 2, j - 1
  V m0 = 0, m1 = 0;   // first-pass rows j - 3, j - 2
  for (int j0 = first; j0 <= last; j0 += kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k;
      V n = 0;
      if (live && j <= last)
        n = noisy<R>(img, reflect_row(j, h), x, w3, seed, sigma,
                     apply_noise);
      const int m = j - 1;
      // rows -1 and h: the order of rows 1 and h - 2
      tap1[k][t] = (!R::kSymmetric && (m == -1 || m == h))
                       ? R::vtap(n, n1, n0)
                       : R::vtap(n0, n1, n);
      n0 = n1;
      n1 = n;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const V mid = R::htap(tap1[k][tl], tap1[k][t], tap1[k][tr]);
      if (double_filter) {
        tap2[k][t] = R::vtap(m0, m1, mid);
        m0 = m1;
        m1 = mid;
      } else {
        const int o = j0 + k - 1;
        if (out_lane && o >= r0 && o < r1)
          store_v(dst, (size_t)o * w3 + x, mid);
      }
    }
    __syncthreads();
    if (double_filter) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int o = j0 + k - 2;
        if (out_lane && o >= r0 && o < r1)
          store_v(dst, (size_t)o * w3 + x,
                  R::htap(tap2[k][tl], tap2[k][t], tap2[k][tr]));
      }
    }
  }
}

// Rows a segment: the fewest waves of kGBlocksPerSm blocks on every SM
// times the rows (plus 4 halo rows) a block walks.  The kernel is bound by
// latency as much as by issue, so a wave that fills every SM's block
// slots beats one with fewer, longer blocks.
int seg_rows_for(int b, int h, int strips) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int best = h, best_cost = -1;
  for (int rows = h; rows >= 8; --rows) {
    const int segs = (h + rows - 1) / rows;
    if ((h + segs - 1) / segs != rows) continue;   // same segments, fewer rows
    const long long blocks = (long long)strips * segs * b;
    const long long slots = (long long)sms * kGBlocksPerSm;
    const long long cost = (blocks + slots - 1) / slots * (rows + 4);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rows;
    }
  }
  return best;
}

template <typename T, typename R>
int launch_gauss(const T* in, T* out, const int* seeds, const float* sigmas,
                 int b, int h, int w3, int apply_noise, int double_filter,
                 cudaStream_t stream) {
  const int strips = (w3 + kGOut - 1) / kGOut;
  const int rows = seg_rows_for(b, h, strips);
  const dim3 grid(strips, (h + rows - 1) / rows, b);
  gauss_blur_kernel<T, R><<<grid, kGThreads, 0, stream>>>(
      in, out, seeds, sigmas, h, w3, rows, apply_noise, double_filter);
  return (int)cudaGetLastError();
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
  return launch_gauss<uint8_t, IntRoute>(
      (const uint8_t*)in, (uint8_t*)out, (const int*)seeds,
      (const float*)sigmas, b, h, w3, apply_noise, double_filter,
      (cudaStream_t)stream);
}

// f32 images: the integer route when noise is applied (its values are
// then integers), else the float route
int gauss_blur_f32(const void* in, void* out, const void* seeds,
                   const void* sigmas, int b, int h, int w3, int apply_noise,
                   int double_filter, void* stream) {
  if (apply_noise)
    return launch_gauss<float, IntRoute>(
        (const float*)in, (float*)out, (const int*)seeds,
        (const float*)sigmas, b, h, w3, apply_noise, double_filter,
        (cudaStream_t)stream);
  return launch_gauss<float, FloatRoute>(
      (const float*)in, (float*)out, (const int*)seeds, (const float*)sigmas,
      b, h, w3, apply_noise, double_filter, (cudaStream_t)stream);
}

}  // extern "C"
