// Packed NMS for Hopper (sm_90a), batched over problems: the suppression
// words (kernel 3) and the greedy walk over them.
//
// mask_kernel replaces the Pallas TPU kernel
// tpudenoise/ops/nms.py::_mask_tile_kernel (entry
// build_suppression_masks_pallas): over score-SORTED boxes, bit b of
// int32 word [wi, j] is set when box i = wi*32 + b suppresses box j, i.e.
// i < j and IoU(i, j) > thresh with the reference's +1 pixel convention.
// The words must equal the plain version build_suppression_masks word for
// word, so the bit is exactly fl(inter / den) > f32(thresh) with
// den = (area_i + area_j) - inter, every value rounded as _iou_tile
// rounds it (built with --fmad=false, no fast math).
//
// What bounds it on this card: the ~15 float operations of each of the
// N(N-1)/2 pairs i < j (6144 boxes x 8 images: 1.5e8 pairs), not memory:
// the output is N^2/32 words (4.7 MB an image, 37.7 MB for the batch of
// 8) and the boxes fit in L1.  Design:
// * no divide: for den finite and > 0, fl(inter/den) > t holds iff
//   inter > m*den, or inter == m*den and the float after t has an even
//   significand (the tie rounds to it), where m is the midpoint between t
//   and that float.  m*den (25 x 24 significant bits) is exact in a
//   double.  Two float products first bracket m*den (den*t_hi above it,
//   den*t_lo below it), so nearly every pair is decided in floats and
//   only pairs within ~2^-19 of the threshold take the double compare;
//   any other den (<= 0, inf, NaN) keeps the IEEE divide.
//   iou_exceeds in ops/nms.py is the same predicate in numpy.
// * one block per 128 x 128 tile on or above the diagonal: the tile's 128
//   row boxes sit in shared memory (broadcast reads), each thread owns
//   one column and builds its 4 words in registers, written once,
//   coalesced across the columns.  The block also writes the zeros of
//   the mirror tile below the diagonal, so no block runs for those.
//   (Two columns a thread in blocks of 64 ran slower on the card.)
//
// greedy_kernel has no Pallas counterpart (the reference's nms_packed
// iterates sweeps over the words to a fixpoint in XLA): it computes the
// greedy keep set from the words in one pass, as the CUDA reference's
// host loop does, on the device, so the host never waits on NMS.  One
// block per problem walks strips of 32 score-sorted boxes: warp 0 decides
// the strip's boxes in order from the strip's 32 diagonal words, the
// removed bits and the validity flags; the block then ORs the kept rows'
// words into the removed bits of every later column (one ballot a warp
// per word of columns).  The next strip's words are loaded while the
// current one is resolved, and the walk stops once max_out boxes are
// kept.  It is bound by the latency of that serial chain, not by the
// words it must read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kPack = 32;
constexpr int kTile = 128;                 // rows and columns of a tile
constexpr int kWords = kTile / kPack;      // words a thread builds
constexpr int kWalkThreads = 512;
constexpr int kMaxCols = 24;               // columns a walk thread holds
constexpr int kMaxN = kWalkThreads * kMaxCols;

struct Thresh {
  float t;       // f32(thresh)
  float hi, lo;  // den * hi > m * den > den * lo for den in [2^-60, 2^60]
  double mid;    // the midpoint between t and the next float up
  int even;      // that next float has an even significand
  int exact;     // mid is finite: the divide-free form applies
  int band;      // t is in [2^-60, 2^60]: the float bracket applies
};

__device__ __forceinline__ bool exceeds(const float4 r, float ra,
                                        const float4 c, float ca,
                                        const Thresh& th) {
  const float xx1 = fmaxf(r.x, c.x);
  const float yy1 = fmaxf(r.y, c.y);
  const float xx2 = fminf(r.z, c.z);
  const float yy2 = fminf(r.w, c.w);
  const float w = fmaxf(0.0f, xx2 - xx1 + 1.0f);
  const float h = fmaxf(0.0f, yy2 - yy1 + 1.0f);
  const float inter = w * h;
  const float den = (ra + ca) - inter;
  if (th.exact && den > 0.0f && den <= 3.402823466e38f) {
    if (th.band && den >= 0x1p-60f && den <= 0x1p60f) {
      if (inter > den * th.hi) return true;
      if (inter < den * th.lo) return false;
    }
    const double lhs = (double)inter;
    const double rhs = th.mid * (double)den;
    return lhs > rhs || (lhs == rhs && th.even);
  }
  return inter / den > th.t;
}

__device__ __forceinline__ float area_of(const float4 b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

// blockIdx.x: the tile (ti <= tj) numbered column by column,
// t = tj (tj + 1) / 2 + ti; blockIdx.y: the problem.
__global__ void __launch_bounds__(kTile)
mask_kernel(const float4* __restrict__ boxes, int32_t* __restrict__ words,
            int n, Thresh th) {
  __shared__ float4 rows[kTile];
  __shared__ float row_area[kTile];
  const int t = blockIdx.x;
  int tj = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (tj * (tj + 1) / 2 > t) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  const int ti = t - tj * (tj + 1) / 2;
  const int nw = n / kPack;
  const float4* bx = boxes + (size_t)blockIdx.y * n;
  int32_t* out = words + (size_t)blockIdx.y * nw * n;
  const int i0 = ti * kTile;
  const int j = tj * kTile + threadIdx.x;

  if (ti < tj) {  // the mirror tile (tj, ti) lies below the diagonal
    const int jm = i0 + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int wi = tj * kWords + k;
      if (wi < nw) out[(size_t)wi * n + jm] = 0;
    }
  }
  if (i0 + threadIdx.x < n) {
    const float4 r = bx[i0 + threadIdx.x];
    rows[threadIdx.x] = r;
    row_area[threadIdx.x] = area_of(r);
  }
  __syncthreads();
  if (j >= n) return;

  const float4 c = bx[j];
  const float ca = area_of(c);
  uint32_t acc[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc[k] = 0;
  if (ti < tj) {  // every row is above every column: all 32 bits
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
#pragma unroll 8
      for (int bit = 0; bit < kPack; ++bit) {
        const int r = k * kPack + bit;
        if (exceeds(rows[r], row_area[r], c, ca, th)) acc[k] |= 1u << bit;
      }
    }
  } else {        // the diagonal tile: only the bits with i < j
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int bmax = min(kPack, j - (i0 + k * kPack));
      for (int bit = 0; bit < bmax; ++bit) {
        const int r = k * kPack + bit;
        if (exceeds(rows[r], row_area[r], c, ca, th)) acc[k] |= 1u << bit;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int wi = ti * kWords + k;
    if (wi < nw) out[(size_t)wi * n + j] = (int32_t)acc[k];
  }
}

// Row words of strip s for the columns j = k * kWalkThreads + tid that
// lie after the strip (0 for the others).
__device__ __forceinline__ void load_row(uint32_t (&dst)[kMaxCols],
                                         const uint32_t* wd, int n, int s,
                                         int tid) {
  const uint32_t* row = wd + (size_t)s * n;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int j = k * kWalkThreads + tid;
    dst[k] = (j < n && j >= (s + 1) * kPack) ? row[j] : 0u;
  }
}

// One block per problem.  words (P, n/32, n), valid (P, n) bytes, keep
// (P, max_out): the sorted positions of the first max_out kept boxes, -1
// padded.  Thread tid holds the columns j = k * kWalkThreads + tid, so a
// warp's 32 lanes hold one word's worth of columns for each k.
__global__ void __launch_bounds__(kWalkThreads)
greedy_kernel(const uint32_t* __restrict__ words,
              const uint8_t* __restrict__ valid, int32_t* __restrict__ keep,
              int n, int max_out) {
  __shared__ uint32_t removed[kMaxN / kPack];
  __shared__ uint32_t kept_s;
  __shared__ int count_s;
  const int nw = n / kPack;
  const uint32_t* wd = words + (size_t)blockIdx.x * nw * n;
  const uint8_t* vd = valid + (size_t)blockIdx.x * n;
  int32_t* out = keep + (size_t)blockIdx.x * max_out;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < nw; i += kWalkThreads) removed[i] = 0;
  if (tid == 0) count_s = 0;

  // strip s's row words for the later columns (j >= 32 (s + 1)), and for
  // warp 0 the strip's diagonal words and validity flags
  uint32_t cur[kMaxCols], nxt[kMaxCols];
  uint32_t diag = 0, diag_nxt = 0;
  bool ok = false, ok_nxt = false;
  load_row(cur, wd, n, 0, tid);
  if (warp == 0) {
    diag = wd[lane];
    ok = vd[lane] != 0;
  }
  __syncthreads();

  for (int s = 0; s < nw; ++s) {
    if (s + 1 < nw) {
      load_row(nxt, wd, n, s + 1, tid);
      if (warp == 0) {
        const int j = (s + 1) * kPack + lane;
        diag_nxt = wd[(size_t)(s + 1) * n + j];
        ok_nxt = vd[j] != 0;
      }
    }
    if (warp == 0) {
      const uint32_t cand =
          __ballot_sync(0xffffffffu, ok && !((removed[s] >> lane) & 1u));
      uint32_t kept = 0;
#pragma unroll
      for (int c = 0; c < kPack; ++c) {
        const uint32_t d = __shfl_sync(0xffffffffu, diag, c);
        if (((cand >> c) & 1u) && !(d & kept)) kept |= 1u << c;
      }
      const int cnt = count_s;
      if ((kept >> lane) & 1u) {
        const int pos = cnt + __popc(kept & ((1u << lane) - 1u));
        if (pos < max_out) out[pos] = s * kPack + lane;
      }
      __syncwarp();
      if (lane == 0) {
        kept_s = kept;
        count_s = cnt + __popc(kept);
      }
    }
    __syncthreads();
    const uint32_t kept = kept_s;
    if (count_s >= max_out) break;
    if (kept) {
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        if (k * kWalkThreads < n) {
          const uint32_t hit = __ballot_sync(0xffffffffu, (cur[k] & kept)
                                             != 0u);
          if (lane == 0 && hit)
            removed[(k * kWalkThreads + warp * kPack) / kPack] |= hit;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) cur[k] = nxt[k];
    diag = diag_nxt;
    ok = ok_nxt;
  }
  __syncthreads();
  for (int i = count_s + tid; i < max_out; i += kWalkThreads) out[i] = -1;
}

}  // namespace

extern "C" {

// boxes (p, n, 4) float32 score-sorted, words (p, n/32, n) int32, both on
// the device; n a multiple of 32.
int suppression_masks(const void* boxes, void* words, int p, int n,
                      float thresh, void* stream) {
  Thresh th;
  th.t = thresh;
  const float next = nextafterf(thresh, INFINITY);
  th.mid = ((double)thresh + (double)next) * 0.5;
  uint32_t next_bits;
  memcpy(&next_bits, &next, sizeof(next_bits));
  th.even = (int)((next_bits & 1u) == 0u);
  th.exact = (int)isfinite(th.mid);
  th.band = (int)(thresh >= 0x1p-60f && thresh <= 0x1p60f);
  th.hi = thresh * (1.0f + 0x1p-19f);
  th.lo = thresh * (1.0f - 0x1p-19f);
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, p);
  mask_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (int32_t*)words, n, th);
  return (int)cudaGetLastError();
}

// words (p, n/32, n) int32, valid (p, n) bool, keep (p, max_out) int32, on
// the device; n a multiple of 32 and at most kMaxN.
int greedy_keep(const void* words, const void* valid, void* keep, int p,
                int n, int max_out, void* stream) {
  if (n > kMaxN || n % kPack) return (int)cudaErrorInvalidValue;
  greedy_kernel<<<p, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint8_t*)valid, (int32_t*)keep, n,
      max_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
