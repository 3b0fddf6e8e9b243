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
// included.  The reference's tile height only sets hp; these kernels tile
// as they like and give the same bits for every hp.
//
// What bounds each stage on this card, and what the design does about it:
//   * copy and noise: device-memory bytes, one read and one write of each
//     element (the noise adds ~15 integer operations an element, under the
//     card's ratio for u8 and f32 I/O alike).  The copy/noise kernel moves
//     16 bytes a thread, one uint4 load and store (16 u8 lanes or 4 f32
//     lanes), neighbouring threads on neighbouring addresses; a thread's
//     row and its row's hash term are fixed, so no element divides.  A
//     raster whose rows are not 16-byte aligned (w3p * size not a multiple
//     of 16, or a pointer off 16 bytes) takes the same kernel's scalar
//     form.
//   * med1 and full: instruction issue (a hash and one or two 3x3 medians
//     an element).  The walk kernel is kernel 1's row walk (fused_noise.cu;
//     the routes and taps of sap_median.cuh): each thread owns a lane and
//     walks down a segment of rows a pair at a time, sorts each vertical
//     triple once and merges sorted columns shared with lanes +-3.  On the
//     raster it differs from kernel 1 in that the values come from raster
//     row g + 4 unclamped (only the hash row is clamped); outputs cover
//     all hp rows and all w3p lanes; only first-pass rows -1 and h are
//     re-padded (rows h + 1 .. hp are medians of raster rows); segments
//     are planned over hp, so a segment may start at h + 1, where it walks
//     one pair earlier to have filtered row h - 1 for row h.
//
// Routes of the walk: u8 takes PackedMedian (two rows a word, DPX
// min/max).  f32 starts every block on CheckedPacked, the packed route on
// f32 values that are integers in [0, 255] by their bits, where it gives
// the float route's bits; at the first step where a value of the block
// fails that test (known block-wide from __syncthreads_or at the step's
// first barrier, before anything of the step is stored), the block redoes
// that step and walks the rest on FloatMedian, its carried rows converted
// exactly.  sap_stages_f32_float runs f32 on FloatMedian alone, the
// yardstick that the packed start must beat to stay.
//
// Numerics: min/max and the hash are exact, so every stage is bit-exact
// against the plain version and the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sap_median.cuh"

namespace {

using namespace sap;

enum Stage { kCopy = 0, kNoise = 1, kMed1 = 2, kFull = 3 };

// ------------------------------------------------------ copy and noise --

constexpr int kWordThreads = 64;   // x: 16-byte words of a row
constexpr int kWordRows = 4;       // y: rows

template <typename T>
__device__ __forceinline__ T salt_pepper_t(T v, uint32_t bits,
                                           uint32_t thresh) {
  return bits < thresh ? T((bits & 1u) ? 255 : 0) : v;
}

template <typename T, int S, bool kVec>
__global__ void __launch_bounds__(kWordThreads * kWordRows)
sap_stages_copy_noise_kernel(const T* __restrict__ in, T* __restrict__ out,
                             const int* __restrict__ seeds, int h, int w3,
                             int hp, int w3p, uint32_t thresh) {
  constexpr int N = 16 / (int)sizeof(T);   // lanes a thread
  const int g = blockIdx.y * kWordRows + threadIdx.y;
  const int x0 = (blockIdx.x * kWordThreads + threadIdx.x) * N;
  if (g >= hp || x0 >= w3p) return;
  const int b = blockIdx.z;
  const T* src = in + ((size_t)b * (hp + 8) + g + 4) * w3p + x0;
  T* dst = out + ((size_t)b * hp + g) * w3p + x0;
  union {
    uint4 q;
    T e[N];
  } v;
  if constexpr (kVec) {
    v.q = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v.e[i] = x0 + i < w3p ? src[i] : T(0);
  }
  if constexpr (S == kNoise) {
    const uint32_t seed = (uint32_t)seeds[b];
    const uint32_t iy = (uint32_t)min(g, h - 1);   // g >= 0
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t ix = (uint32_t)min(x0 + i, w3 - 1);
      v.e[i] = salt_pepper_t(v.e[i], hash2d_row(iy, hash2d_lane(ix, seed)),
                             thresh);
    }
  }
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(dst) = v.q;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (x0 + i < w3p) dst[i] = v.e[i];
  }
}

template <typename T, int S>
int launch_copy_noise(const T* in, T* out, const int* seeds, int b, int h,
                      int w3, int hp, int w3p, uint32_t thresh,
                      cudaStream_t stream) {
  constexpr int N = 16 / (int)sizeof(T);
  const dim3 block(kWordThreads, kWordRows);
  const dim3 grid(((w3p + N - 1) / N + kWordThreads - 1) / kWordThreads,
                  (hp + kWordRows - 1) / kWordRows, b);
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   ((size_t)w3p * sizeof(T)) % 16 == 0;
  if (vec)
    sap_stages_copy_noise_kernel<T, S, true><<<grid, block, 0, stream>>>(
        in, out, seeds, h, w3, hp, w3p, thresh);
  else
    sap_stages_copy_noise_kernel<T, S, false><<<grid, block, 0, stream>>>(
        in, out, seeds, h, w3, hp, w3p, thresh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- med1 and full ----
//
// 640 threads own one lane each of a 640-lane window whose middle 628 are
// the block's output lanes, three blocks an SM: the profiling rasters'
// w3p = 3072 takes 5 strips (3140 lanes, 2.2% idle), and 60 warps an SM
// hide the loads better than kernel 1's 48.  ptxas caps them at 32
// registers (65536 over 3 x 640); the stage as a template parameter keeps
// u8 and the float walk free of spills there, the f32 packed start spills
// 16-40 bytes.  On an H100 this layout ran every walk faster than 800
// threads two to an SM (4 strips, also capped at 32 registers by ptxas)
// and than 768 threads two to an SM (40 registers, 5 strips):
// benchmarks/stage_variants.py, PERF.md section 6.

constexpr int kThreads = 640;
constexpr int kHalo = 6;                       // two stencils x 3 lanes
constexpr int kOut = kThreads - 2 * kHalo;     // output lanes a block
constexpr int kBlocksPerSm = 3;                // launch bounds

// The packed route on f32 values: a value whose bits are those of an
// integer in [0, 255] goes in as that integer (NaN, -0.0 and any other
// value set `bad`); outputs go out as floats.
struct CheckedPacked : PackedMedian {
  static __device__ __forceinline__ S checked_value(const float* p,
                                                    uint32_t bits,
                                                    uint32_t thresh,
                                                    bool& bad) {
    const float v = *p;
    const int i = __float2int_rz(v);
    bad |= (__float_as_uint(__int2float_rn(i)) != __float_as_uint(v)) |
           ((uint32_t)i > 255u);
    return bits < thresh ? ((bits & 1u) ? 255u : 0u) : (uint32_t)i;
  }
  static __device__ __forceinline__ void store_top(float* p, V m) {
    *p = (float)(m & 0xFFFFu);
  }
  static __device__ __forceinline__ void store_bot(float* p, V m) {
    *p = (float)(m >> 16);
  }
};

template <typename R>
struct Checked {
  static constexpr bool value = false;
};
template <>
struct Checked<CheckedPacked> {
  static constexpr bool value = true;
};

template <typename R, typename T>
__device__ __forceinline__ typename R::S noisy_value(const T* p,
                                                     uint32_t bits,
                                                     uint32_t thresh,
                                                     bool& bad) {
  if constexpr (Checked<R>::value)
    return R::checked_value(p, bits, thresh, bad);
  else
    return R::value(p, bits, thresh);
}

template <typename R>
constexpr int walk_smem_bytes() {
  return 2 * (int)sizeof(Taps<R, kThreads>);   // first pass, second pass
}
static_assert(walk_smem_bytes<PackedMedian>() ==
                  walk_smem_bytes<FloatMedian>(),
              "a block that leaves the packed route reuses its taps");
static_assert(kBlocksPerSm * walk_smem_bytes<PackedMedian>() <= 227 * 1024,
              "three blocks' columns fit an SM's shared memory");

// what a thread's walk needs, fixed for the block's segment
template <typename T>
struct Walk {
  const T* img;      // this lane's global row 0 (raster row 4)
  T* dst;            // this lane's output row 0
  uint32_t lane;     // the lane's hash term
  uint32_t thresh;
  int h, hp, w3p;
  int r0, r1;        // output rows [r0, r1)
  int t, tl, tr;     // window positions of the lane and its neighbours
  bool out_lane;
};

// One step: P pairs from pair j0 (kernel 1's step on the raster).  An edge
// step clamps the hash row to [0, h - 1] and the raster row to at most
// hp + 3 (rows past it feed no output), checks each output row against the
// segment and re-pads first-pass rows -1 and h; an interior one does none
// of it.  A checked route returns true, block-wide and with nothing of the
// step stored, where a value of the block failed its test; `a` is then as
// it was before the step.
template <typename R, bool kFull, bool kEdge, typename T>
__device__ __forceinline__ bool walk_step(const Walk<T>& w, int j0,
                                          typename R::V& a,
                                          typename R::V& mp,
                                          unsigned char* smem) {
  using V = typename R::V;
  using S = typename R::S;
  constexpr int P = R::kPairs;
  Taps<R, kThreads>& tap1 = *reinterpret_cast<Taps<R, kThreads>*>(smem);
  Taps<R, kThreads>& tap2 = *reinterpret_cast<Taps<R, kThreads>*>(
      smem + sizeof(Taps<R, kThreads>));
  const int t = w.t;
  const V a_in = a;
  bool bad = false;
  V lo[P], mid[P], hi[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    S n[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 2 * k + i;
      const int y = kEdge ? min(j, w.hp + 3) : j;
      const int iy = kEdge ? min(max(j, 0), w.h - 1) : j;
      n[i] = noisy_value<R>(w.img + (long long)y * w.w3p,
                            hash2d_row((uint32_t)iy, w.lane), w.thresh, bad);
    }
    const V c = R::pack(n[0], n[1]);
    R::sort3(a, R::join(a, c), c, lo[k], mid[k], hi[k]);
    tap1[k][0][t] = lo[k];
    tap1[k][1][t] = mid[k];
    tap1[k][2][t] = hi[k];
    a = c;
  }
  if constexpr (Checked<R>::value) {
    if (__syncthreads_or(bad)) {
      a = a_in;
      return true;
    }
  } else {
    __syncthreads();
  }
  // output rows o, o + 1 of a pair
  auto put = [&](int o, V v) {
    T* q = w.dst + (long long)o * w.w3p;
    if (w.out_lane && (!kEdge || (o >= w.r0 && o < w.r1))) R::store_top(q, v);
    if (w.out_lane && (!kEdge || (o + 1 >= w.r0 && o + 1 < w.r1)))
      R::store_bot(q + w.w3p, v);
  };
  V m[P];
#pragma unroll
  for (int k = 0; k < P; ++k)
    m[k] = merge<R>(tap1[k], w.tl, w.tr, lo[k], mid[k], hi[k]);
  if constexpr (kFull) {
    // first-pass rows -1 and h take rows 0 and h - 1; rows past h keep
    // their own medians
    if (kEdge && (j0 <= 0 || j0 + 2 * P > w.h)) {
      V prev = mp;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = j0 + 2 * k;
        if (j == 0) m[k] = R::both_bot(m[k]);
        if (j == w.h) m[k] = R::both_top(m[k]);
        if (j == w.h + 1) m[k] = R::top_from(m[k], prev);
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
  if constexpr (kFull) {
#pragma unroll
    for (int k = 0; k < P; ++k)
      put(j0 + 2 * k - 2, merge<R>(tap2[k], w.tl, w.tr, lo[k], mid[k], hi[k]));
  }
  return false;
}

// Steps from pair j0 to the segment's end, or, on a checked route, to the
// first step whose values fail the test; returns that step's j0.
template <typename R, bool kFull, typename T>
__device__ __forceinline__ int walk_rows(const Walk<T>& w, int j0,
                                         typename R::V& a,
                                         typename R::V& mp,
                                         unsigned char* smem) {
  constexpr int kRows = 2 * R::kPairs;
  constexpr int d = kFull ? 2 : 1;   // output rows j - d, j - d + 1
  for (; j0 - d < w.r1; j0 += kRows) {
    // block-uniform: rows j0 .. j0 + kRows - 1 loaded, j0 - d .. j0 - d +
    // kRows - 1 stored
    const bool bad =
        (j0 - d >= w.r0 && j0 - d + kRows <= w.r1 && j0 + kRows <= w.h)
            ? walk_step<R, kFull, false>(w, j0, a, mp, smem)
            : walk_step<R, kFull, true>(w, j0, a, mp, smem);
    if (Checked<R>::value && bad) break;
  }
  return j0;
}

__device__ __forceinline__ float2 unpack(uint32_t m) {
  return make_float2((float)(m & 0xFFFFu), (float)(m >> 16));
}

// kFull: two medians (the full stage), else one (med1)
template <typename T, typename R, bool kFull>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sap_stages_walk_kernel(const T* __restrict__ in, T* __restrict__ out,
                       const int* __restrict__ seeds, int h, int w3, int hp,
                       int w3p, int seg_rows, uint32_t thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  Walk<T> w;
  w.t = threadIdx.x;
  const int b = blockIdx.z;
  const int x = blockIdx.x * kOut - kHalo + w.t;   // this thread's lane
  // window positions of the horizontal neighbours (BORDER_REPLICATE; pad
  // lanes take themselves as right neighbour); lanes at the window's edges
  // and outside the raster are never read
  const bool mid_lane = w.t >= 3 && w.t < kThreads - 3;
  w.tl = mid_lane && x >= 3 ? w.t - 3 : w.t;
  w.tr = mid_lane && x < w3 - 3 ? w.t + 3 : w.t;
  w.out_lane = x >= 0 && x < w3p && w.t >= kHalo && w.t < kThreads - kHalo;
  const int xc = min(max(x, 0), w3p - 1);
  w.lane = hash2d_lane((uint32_t)min(xc, w3 - 1), (uint32_t)seeds[b]);
  w.thresh = thresh;
  w.h = h;
  w.hp = hp;
  w.w3p = w3p;
  w.r0 = blockIdx.y * seg_rows;
  w.r1 = min(w.r0 + seg_rows, hp);
  w.img = in + ((size_t)b * (hp + 8) + 4) * w3p + xc;
  w.dst = out + (size_t)b * hp * w3p + x;
  constexpr int d = kFull ? 2 : 1;
  // the first pair's rows are garbage (nothing carried yet): a segment
  // that starts at h + 1 needs filtered row h - 1, so it starts a pair
  // earlier
  int j0 = w.r0 - d - (kFull && w.r0 == h + 1 ? 2 : 0);
  typename R::V a = R::zero();    // noisy rows j - 2, j - 1
  typename R::V mp = R::zero();   // first-pass rows j - 3, j - 2
  j0 = walk_rows<R, kFull>(w, j0, a, mp, smem);
  if constexpr (Checked<R>::value) {
    if (j0 - d >= w.r1) return;
    // integers in [0, 255]: the float route's values, exactly
    float2 fa = unpack(a), fmp = unpack(mp);
    walk_rows<FloatMedian, kFull>(w, j0, fa, fmp, smem);
  }
}

template <typename T, typename R, bool kFull>
int launch_walk(const T* in, T* out, const int* seeds, int b, int h, int w3,
                int hp, int w3p, uint32_t thresh, cudaStream_t stream) {
  constexpr int smem = walk_smem_bytes<R>();
  // above 48 KB of dynamic shared memory only once allowed: once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(sap_stages_walk_kernel<T, R, kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  const int strips = (w3p + kOut - 1) / kOut;
  const int rows =
      seg_rows_for(b, hp, strips, 2 * R::kPairs, kBlocksPerSm);
  const dim3 grid(strips, (hp + rows - 1) / rows, b);
  sap_stages_walk_kernel<T, R, kFull><<<grid, kThreads, smem, stream>>>(
      in, out, seeds, h, w3, hp, w3p, rows, thresh);
  return (int)cudaGetLastError();
}

// W: the walk's route for med1 and full
template <typename T, typename W>
int stages(const void* in_, void* out_, const void* seeds_, int b, int h,
           int w3, int hp, int w3p, int stage, int thresh_, void* stream_) {
  const T* in = (const T*)in_;
  T* out = (T*)out_;
  const int* seeds = (const int*)seeds_;
  const uint32_t thresh = (uint32_t)thresh_;
  const cudaStream_t stream = (cudaStream_t)stream_;
  switch (stage) {
    case kCopy:
      return launch_copy_noise<T, kCopy>(in, out, seeds, b, h, w3, hp, w3p,
                                         thresh, stream);
    case kNoise:
      return launch_copy_noise<T, kNoise>(in, out, seeds, b, h, w3, hp, w3p,
                                          thresh, stream);
    case kMed1:
      return launch_walk<T, W, false>(in, out, seeds, b, h, w3, hp, w3p,
                                      thresh, stream);
    case kFull:
      return launch_walk<T, W, true>(in, out, seeds, b, h, w3, hp, w3p,
                                     thresh, stream);
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
  return stages<float, CheckedPacked>(in, out, seeds, b, h, w3, hp, w3p,
                                      stage, thresh, stream);
}

int sap_stages_u8(const void* in, void* out, const void* seeds, int b, int h,
                  int w3, int hp, int w3p, int stage, int thresh,
                  void* stream) {
  return stages<uint8_t, PackedMedian>(in, out, seeds, b, h, w3, hp, w3p,
                                       stage, thresh, stream);
}

// f32 on the float walk alone: the yardstick of the packed start
// (benchmarks/profile_noise_kernels.py times both); no wrapper calls it
int sap_stages_f32_float(const void* in, void* out, const void* seeds, int b,
                         int h, int w3, int hp, int w3p, int stage,
                         int thresh, void* stream) {
  return stages<float, FloatMedian>(in, out, seeds, b, h, w3, hp, w3p, stage,
                                    thresh, stream);
}

}  // extern "C"
