// Fused noise + 3x3 denoise in one device-memory pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpudenoise/noise/pallas_kernels.py:
//   * sap_median_*  <- _fused_batched_kernel / fused_sap_median_batched
//     and _fused_kernel / fused_sap_median (one image a call)
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
// ~9 us at 3.35 TB/s) are far below the work: a hash and two 3x3 medians
// per element for sap + median, two hashes and IEEE logf/sqrtf/cosf for
// the gaussian.  Both kernels walk down column strips (the section
// below): each thread owns one lane, draws each element's noise once and
// keeps its lane's last rows in registers, so that a vertical step is
// computed once, by the thread of its lane, and only the +-3-lane
// neighbours go through shared memory.
//
// Numerics: built with --fmad=false and without fast math, so every float
// operation rounds where the reference's XLA CPU code rounds; the order of
// operations below follows pallas_kernels.py term by term.  Only logf/cosf
// may differ from XLA's by an ulp, which can move a truncated u8 by one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sap_median.cuh"

namespace {

using namespace sap;  // hash2d*, load_f32, store, salt_pepper, sort3, med3

// ---------------------------------------------------------- the walk ----
//
// One block owns a strip of kOut output lanes [c0, c0 + kOut) and a
// segment of rows [r0, r1); its kThreads threads own one lane each of the
// window [c0 - 6, c0 + kOut + 6) (two stencils of +-3 lanes) and walk
// down the rows a step at a time, with two barriers a step: the first
// pass's vertical results go through shared memory to lanes +-3, then the
// second pass's.  At (8, 600, 1000, 3), 4 strips x 8 segments of 75 rows
// x 8 images = 256 blocks, two on each SM, draw 1.066x the output
// elements' noise (16 x 256 tiles drew 1.31x).  On an H100, 768-thread
// blocks two to an SM ran kernel 2 20% faster than 256 threads four or
// five to an SM (PERF.md, section 6).

constexpr int kThreads = 768;
constexpr int kHalo = 6;                       // two stencils x 3 lanes
constexpr int kOut = kThreads - 2 * kHalo;     // output lanes a block
constexpr int kBlocksPerSm = 2;                // launch bounds

// Rows a segment: the fewest waves of kBlocksPerSm blocks on every SM
// times the rows a block walks (the segment, 4 halo rows, rounded up to
// whole steps of `step` rows).  The kernels are bound by latency as much
// as by issue, so a wave that fills every SM's block slots beats one with
// fewer, longer blocks.
int seg_rows_for(int b, int h, int strips, int step) {
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
    const long long slots = (long long)sms * kBlocksPerSm;
    const long long walked = (rows + 4 + step - 1) / step * step;
    const long long cost = (blocks + slots - 1) / slots * walked;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rows;
    }
  }
  return best;
}

// ------------------------------------------- salt & pepper + median ----
//
// Kernel 1 (and kernel 4, its one-image launch).  The walk steps over
// PAIRS of rows: pair j loads noisy rows j and j + 1 (rows clamped to
// [0, h - 1]: BORDER_REPLICATE), sorts its lane's two vertical triples
// (rows j - 2 .. j and j - 1 .. j + 1) once, and shares the sorted
// columns (lo, mid, hi) with lanes +-3.  A 3x3 median is then the merge of
// three sorted columns, median9's own last step: med3(max of the los,
// med3 of the mids, min of the his).  The first pass gives rows j - 1 and
// j; the second pass sorts the thread's own first-pass rows j - 3 .. j
// the same way and gives output rows j - 2 and j - 1 (one median: rows
// j - 1 and j are the output).  Per element and pass: one column sort,
// three shared stores and six loads, against median9's three sorts and
// nine loads.  First-pass rows -1 and h are replaced by rows 0
// and h - 1 before the second pass (cv2 re-pads the filtered image);
// lanes x < 3 take themselves as left neighbour, lanes x >= w3 - 3 as
// right one.
//
// Two routes, chosen by the input's type:
//   * PackedMedian (u8): after salt & pepper every value is an integer in
//     [0, 255], so one 32-bit word holds a lane at both rows of a pair
//     (u16x2: row j in bits 0-15, row j + 1 in bits 16-31) and Hopper's
//     DPX three-input min/max sort both rows' columns at once:
//     lo = vimin3(a, b, c), hi = vimax3(a, b, c), mid = a + b + c - lo -
//     hi (no half exceeds 765, so nothing carries or borrows across the
//     halves; tests/test_torch_kernel_forms.py checks every u8 triple);
//   * FloatMedian (f32, any value): the same walk on float pairs with
//     sap::sort3 and median9's merge, operation for operation, so NaN and
//     signed zeros come out as median9 gives them.

struct PackedMedian {
  using V = uint32_t;   // a lane at rows j (bits 0-15) and j + 1 (16-31)
  using S = uint32_t;   // one element
  static constexpr int kPairs = 4;   // pairs a step: 8 rows
  static __device__ __forceinline__ V zero() { return 0u; }
  template <typename T>
  static __device__ __forceinline__ S value(const T* p, uint32_t bits,
                                            uint32_t thresh) {
    static_assert(sizeof(T) == 1, "the packed route takes u8 images");
    const uint32_t v = *p;
    return bits < thresh ? ((bits & 1u) ? 255u : 0u) : v;
  }
  static __device__ __forceinline__ V pack(S top, S bot) {
    return __byte_perm(top, bot, 0x5410);
  }
  // (a's second row, c's first row): the pair between a and c
  static __device__ __forceinline__ V join(V a, V c) {
    return __byte_perm(a, c, 0x5432);
  }
  static __device__ __forceinline__ void sort3(V a, V b, V c, V& lo, V& mid,
                                               V& hi) {
    lo = __vimin3_u16x2(a, b, c);
    hi = __vimax3_u16x2(a, b, c);
    mid = a + b + c - lo - hi;
  }
  static __device__ __forceinline__ V max3(V l, V c, V r) {
    return __vimax3_u16x2(l, c, r);
  }
  static __device__ __forceinline__ V min3(V l, V c, V r) {
    return __vimin3_u16x2(l, c, r);
  }
  static __device__ __forceinline__ V med3(V a, V b, V c) {
    return a + b + c - __vimax3_u16x2(a, b, c) - __vimin3_u16x2(a, b, c);
  }
  static __device__ __forceinline__ V both_bot(V m) {
    return __byte_perm(m, 0, 0x3232);
  }
  static __device__ __forceinline__ V both_top(V m) {
    return __byte_perm(m, 0, 0x1010);
  }
  // (prev's second row, m's second row)
  static __device__ __forceinline__ V top_from(V m, V prev) {
    return __byte_perm(prev, m, 0x7632);
  }
  static __device__ __forceinline__ void store_top(uint8_t* p, V m) {
    *p = (uint8_t)m;
  }
  static __device__ __forceinline__ void store_bot(uint8_t* p, V m) {
    *p = (uint8_t)(m >> 16);
  }
};

struct FloatMedian {
  using V = float2;     // x: row j, y: row j + 1
  using S = float;
  static constexpr int kPairs = 2;   // pairs a step: 4 rows (the same
                                     // shared memory as PackedMedian's 8)
  static __device__ __forceinline__ V zero() { return make_float2(0.f, 0.f); }
  template <typename T>
  static __device__ __forceinline__ S value(const T* p, uint32_t bits,
                                            uint32_t thresh) {
    return salt_pepper(load_f32(p, 0), bits, thresh);
  }
  static __device__ __forceinline__ V pack(S top, S bot) {
    return make_float2(top, bot);
  }
  static __device__ __forceinline__ V join(V a, V c) {
    return make_float2(a.y, c.x);
  }
  static __device__ __forceinline__ void sort3(V a, V b, V c, V& lo, V& mid,
                                               V& hi) {
    sap::sort3(a.x, b.x, c.x, lo.x, mid.x, hi.x);
    sap::sort3(a.y, b.y, c.y, lo.y, mid.y, hi.y);
  }
  // median9's merge, in its order: fmaxf(fmaxf(l, c), r), fminf(fminf(l,
  // c), r), sap::med3
  static __device__ __forceinline__ V max3(V l, V c, V r) {
    return make_float2(fmaxf(fmaxf(l.x, c.x), r.x),
                       fmaxf(fmaxf(l.y, c.y), r.y));
  }
  static __device__ __forceinline__ V min3(V l, V c, V r) {
    return make_float2(fminf(fminf(l.x, c.x), r.x),
                       fminf(fminf(l.y, c.y), r.y));
  }
  static __device__ __forceinline__ V med3(V a, V b, V c) {
    return make_float2(sap::med3(a.x, b.x, c.x), sap::med3(a.y, b.y, c.y));
  }
  static __device__ __forceinline__ V both_bot(V m) {
    return make_float2(m.y, m.y);
  }
  static __device__ __forceinline__ V both_top(V m) {
    return make_float2(m.x, m.x);
  }
  static __device__ __forceinline__ V top_from(V m, V prev) {
    return make_float2(prev.y, m.y);
  }
  template <typename T>
  static __device__ __forceinline__ void store_top(T* p, V m) {
    store(p, 0, m.x);
  }
  template <typename T>
  static __device__ __forceinline__ void store_bot(T* p, V m) {
    store(p, 0, m.y);
  }
};

// sorted columns of a step: [pair][lo, mid, hi][lane]
template <typename R>
using Taps = typename R::V[R::kPairs][3][kThreads];

// A 3x3 median of a pair: the sorted columns of lanes tl and tr from the
// taps, the thread's own from registers, merged as median9 merges them
// (max of the los, med3 of the mids, min of the his, med3 of those).
template <typename R, typename V = typename R::V>
__device__ __forceinline__ V merge(const V (&taps)[3][kThreads], int tl,
                                   int tr, V lo, V mid, V hi) {
  return R::med3(R::max3(taps[0][tl], lo, taps[0][tr]),
                 R::med3(taps[1][tl], mid, taps[1][tr]),
                 R::min3(taps[2][tl], hi, taps[2][tr]));
}

template <typename R>
constexpr int sap_smem_bytes() {
  return 2 * (int)sizeof(Taps<R>);   // first pass, second pass
}
static_assert(kBlocksPerSm * sap_smem_bytes<PackedMedian>() <= 227 * 1024 &&
                  kBlocksPerSm * sap_smem_bytes<FloatMedian>() <= 227 * 1024,
              "two blocks' columns fit an SM's shared memory");

template <bool B>
struct Edge {
  static constexpr bool value = B;
};

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sap_median_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds, int h, int w3, int seg_rows,
                  uint32_t thresh, int double_filter) {
  using V = typename R::V;
  using S = typename R::S;
  constexpr int P = R::kPairs;
  extern __shared__ __align__(16) unsigned char smem[];
  Taps<R>& tap1 = *reinterpret_cast<Taps<R>*>(smem);
  Taps<R>& tap2 = *reinterpret_cast<Taps<R>*>(smem + sizeof(Taps<R>));
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int x = blockIdx.x * kOut - kHalo + t;   // this thread's lane
  // window positions of the horizontal neighbours (BORDER_REPLICATE);
  // lanes at the window's edges and outside the image are never read
  const bool mid_lane = t >= 3 && t < kThreads - 3;
  const int tl = mid_lane && x >= 3 ? t - 3 : t;
  const int tr = mid_lane && x < w3 - 3 ? t + 3 : t;
  const bool out_lane = x >= 0 && x < w3 && t >= kHalo && t < kThreads - kHalo;
  const int xc = min(max(x, 0), w3 - 1);
  const uint32_t lane = hash2d_lane((uint32_t)xc, (uint32_t)seeds[b]);
  const int r0 = blockIdx.y * seg_rows;
  const int r1 = min(r0 + seg_rows, h);
  const T* img = in + (size_t)b * h * w3 + xc;
  T* dst = out + (size_t)b * h * w3 + x;
  const int d = double_filter ? 2 : 1;   // output rows j - d, j - d + 1

  V a = R::zero();    // noisy rows j - 2, j - 1
  V mp = R::zero();   // first-pass rows j - 3, j - 2
  // One step: P pairs from pair j0.  An edge step clamps its rows, checks
  // each output row against the segment and re-pads the first pass; an
  // interior one (every row it loads and stores inside the image and the
  // segment) does none of it, and its row terms are the same for the
  // whole block.
  auto step = [&](auto edge, int j0) {
    constexpr bool kEdge = decltype(edge)::value;
    V lo[P], mid[P], hi[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      S n[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = j0 + 2 * k + i;
        const int y = kEdge ? min(max(j, 0), h - 1) : j;
        n[i] = R::value(img + (long long)y * w3,
                        hash2d_row((uint32_t)y, lane), thresh);
      }
      const V c = R::pack(n[0], n[1]);
      R::sort3(a, R::join(a, c), c, lo[k], mid[k], hi[k]);
      tap1[k][0][t] = lo[k];
      tap1[k][1][t] = mid[k];
      tap1[k][2][t] = hi[k];
      a = c;
    }
    // output rows o, o + 1 of a pair
    auto put = [&](int o, V v) {
      T* q = dst + (long long)o * w3;
      if (out_lane && (!kEdge || (o >= r0 && o < r1))) R::store_top(q, v);
      if (out_lane && (!kEdge || (o + 1 >= r0 && o + 1 < r1)))
        R::store_bot(q + w3, v);
    };
    __syncthreads();
    V m[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      m[k] = merge<R>(tap1[k], tl, tr, lo[k], mid[k], hi[k]);
    if (double_filter) {
      // first-pass rows -1 and h take rows 0 and h - 1
      if (kEdge && (j0 <= 0 || j0 + 2 * P > h)) {
        V prev = mp;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int j = j0 + 2 * k;
          if (j == 0) m[k] = R::both_bot(m[k]);
          if (j == h) m[k] = R::both_top(m[k]);
          if (j == h + 1) m[k] = R::top_from(m[k], prev);
          prev = m[k];
        }
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        R::sort3(mp, R::join(mp, m[k]), m[k], lo[k], mid[k], hi[k]);
        tap2[k][0][t] = lo[k];
        tap2[k][1][t] = mid[k];
        tap2[k][2][t] = hi[k];
        mp = m[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) put(j0 + 2 * k - 1, m[k]);
    }
    __syncthreads();
    if (double_filter) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        put(j0 + 2 * k - 2, merge<R>(tap2[k], tl, tr, lo[k], mid[k], hi[k]));
    }
  };

  for (int j0 = r0 - d; j0 - d < r1; j0 += 2 * P) {
    // block-uniform: rows j0 .. j0 + 2P - 1 loaded, j0 - d .. j0 - d +
    // 2P - 1 stored
    if (j0 - d >= r0 && j0 - d + 2 * P <= r1 && j0 + 2 * P <= h)
      step(Edge<false>{}, j0);
    else
      step(Edge<true>{}, j0);
  }
}

template <typename T, typename R>
int launch_sap(const T* in, T* out, const int* seeds, int b, int h, int w3,
               int thresh, int double_filter, cudaStream_t stream) {
  constexpr int smem = sap_smem_bytes<R>();
  // above 48 KB of dynamic shared memory only once allowed: once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(sap_median_kernel<T, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  const int strips = (w3 + kOut - 1) / kOut;
  const int rows = seg_rows_for(b, h, strips, 2 * R::kPairs);
  const dim3 grid(strips, (h + rows - 1) / rows, b);
  sap_median_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      in, out, seeds, h, w3, rows, (uint32_t)thresh, double_filter);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ gaussian blur ----
//
// The walk above, a row at a time: each thread keeps its lane's last two
// noisy rows and last two first-pass rows in registers and walks kBatch
// rows a step; the vertical taps go through shared memory to lanes +-3.
// On an H100 8 rows a step ran faster than 4 (PERF.md, section 6): the
// noise's logf/sqrtf/cosf chains leave issue slots to other warps, and
// fewer barriers a row stall them less.
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

constexpr int kBatch = 8;                         // rows a step
static_assert(2 * kBatch * kThreads * 4 <= 48 * 1024,
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
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gauss_blur_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const int* __restrict__ seeds,
                  const float* __restrict__ sigmas, int h, int w3,
                  int seg_rows, int apply_noise, int double_filter) {
  using V = typename R::V;
  __shared__ V tap1[kBatch][kThreads];   // first pass: vertical taps
  __shared__ V tap2[kBatch][kThreads];   // second pass: vertical taps
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int x = blockIdx.x * kOut - kHalo + t;   // this thread's lane
  const bool live = x >= 0 && x < w3;
  // first-pass lanes [c0 - 3, c0 + kOut + 3), output lanes [c0, c0 + kOut)
  const bool mid_lane = live && t >= 3 && t < kThreads - 3;
  const bool out_lane = live && t >= kHalo && t < kThreads - kHalo;
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

template <typename T, typename R>
int launch_gauss(const T* in, T* out, const int* seeds, const float* sigmas,
                 int b, int h, int w3, int apply_noise, int double_filter,
                 cudaStream_t stream) {
  const int strips = (w3 + kOut - 1) / kOut;
  const int rows = seg_rows_for(b, h, strips, 1);
  const dim3 grid(strips, (h + rows - 1) / rows, b);
  gauss_blur_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      in, out, seeds, sigmas, h, w3, rows, apply_noise, double_filter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sap_median_u8(const void* in, void* out, const void* seeds, int b, int h,
                  int w3, int thresh, int double_filter, void* stream) {
  return launch_sap<uint8_t, PackedMedian>(
      (const uint8_t*)in, (uint8_t*)out, (const int*)seeds, b, h, w3, thresh,
      double_filter, (cudaStream_t)stream);
}

int sap_median_f32(const void* in, void* out, const void* seeds, int b, int h,
                   int w3, int thresh, int double_filter, void* stream) {
  return launch_sap<float, FloatMedian>(
      (const float*)in, (float*)out, (const int*)seeds, b, h, w3, thresh,
      double_filter, (cudaStream_t)stream);
}

// u8 images through the float route: the yardstick that the packed route
// must beat to stay (benchmarks/profile_noise_kernels.py times both); no
// wrapper calls it
int sap_median_u8_float(const void* in, void* out, const void* seeds, int b,
                        int h, int w3, int thresh, int double_filter,
                        void* stream) {
  return launch_sap<uint8_t, FloatMedian>(
      (const uint8_t*)in, (uint8_t*)out, (const int*)seeds, b, h, w3, thresh,
      double_filter, (cudaStream_t)stream);
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
