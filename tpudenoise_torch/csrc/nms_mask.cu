// Packed NMS suppression masks for Hopper (sm_90a), batched over images.
//
// Replaces the Pallas TPU kernel tpudenoise/ops/nms.py::_mask_tile_kernel
// (entry build_suppression_masks_pallas, consumer nms_packed): over
// score-SORTED boxes, bit b of int32 word [wi, j] is set when box
// i = wi*32 + b suppresses box j, i.e. i < j and IoU(i, j) > thresh with
// the reference's +1 pixel convention.  Words must equal the XLA builder
// build_suppression_masks word for word, so the IoU is evaluated exactly as
// _iou_tile does: inter / ((area_i + area_j) - inter) in IEEE f32 (built
// with --fmad=false, no fast math), compared with > against f32(thresh).
//
// What bounds it on this card: the IoU arithmetic of the N^2/2 upper-
// triangle pairs (~15 flops and one IEEE divide each; 6144 boxes x 8
// images = 1.5e8 pairs), not memory: the output is N^2/32 words (4.7 MB
// for the batch) and the boxes fit in L1.  Design: one thread per column
// j of a 32-row strip; the strip's 32 boxes sit in shared memory (one
// broadcast read per row) and the thread assembles its word in a register
// and writes it once, coalesced across j.  Strips wholly at or below the
// diagonal (every i >= j) are written as zero without IoU work, which
// halves the divides.  No tensor cores: the divide and compare dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPack = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float4* __restrict__ boxes, int32_t* __restrict__ words,
            int n, float thresh) {
  __shared__ float4 strip[kPack];
  __shared__ float strip_area[kPack];
  const int b = blockIdx.z;
  const int wi = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const float4* bx = boxes + (size_t)b * n;
  const int i0 = wi * kPack;

  // the whole block lies at or below the diagonal: every i >= every j
  const int j_last = min((int)(blockIdx.x + 1) * (int)blockDim.x, n) - 1;
  if (i0 >= j_last) {
    if (j < n) words[((size_t)b * (n / kPack) + wi) * n + j] = 0;
    return;
  }
  if (threadIdx.x < kPack) {
    const float4 r = bx[i0 + threadIdx.x];
    strip[threadIdx.x] = r;
    strip_area[threadIdx.x] = (r.z - r.x + 1.0f) * (r.w - r.y + 1.0f);
  }
  __syncthreads();
  if (j >= n) return;

  const float4 c = bx[j];
  const float area = (c.z - c.x + 1.0f) * (c.w - c.y + 1.0f);
  uint32_t word = 0;
  const int bmax = min(kPack, j - i0);  // bits with i < j
  for (int bit = 0; bit < bmax; ++bit) {
    const float4 r = strip[bit];
    const float xx1 = fmaxf(r.x, c.x);
    const float yy1 = fmaxf(r.y, c.y);
    const float xx2 = fminf(r.z, c.z);
    const float yy2 = fminf(r.w, c.w);
    const float w = fmaxf(0.0f, xx2 - xx1 + 1.0f);
    const float h = fmaxf(0.0f, yy2 - yy1 + 1.0f);
    const float inter = w * h;
    const float iou = inter / ((strip_area[bit] + area) - inter);
    if (iou > thresh) word |= 1u << bit;
  }
  words[((size_t)b * (n / kPack) + wi) * n + j] = (int32_t)word;
}

}  // namespace

extern "C" int suppression_masks(const void* boxes, void* words, int b, int n,
                                 float thresh, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, n / kPack, b);
  mask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (int32_t*)words, n, thresh);
  return (int)cudaGetLastError();
}
