// Device helpers of the salt & pepper + 3x3 median kernels, shared by
// fused_noise.cu (sap_median_*) and sap_stages.cu (the stage-cut profiling
// forks), so that their arithmetic cannot drift apart.
//
// Counterparts of tpudenoise/noise/pallas_kernels.py: _hash2d, _load_f32 /
// _store_row_block, _med3 and the column-sort form of _median3_tile.
// hash2d_lane / hash2d_row serve fused_noise.cu's row walk, which hashes
// down one lane.

#pragma once

#include <stdint.h>

namespace sap {

// the coordinate hash of _hash2d (splitmix-style avalanche)
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

// hash2d split for a walk down one lane: the lane and seed terms, fixed
// for the lane, once; then each row's hash from them.
// hash2d_row(iy, hash2d_lane(ix, seed)) == hash2d(iy, ix, seed).
__device__ __forceinline__ uint32_t hash2d_lane(uint32_t ix, uint32_t seed) {
  return (ix * 0x85EBCA6Bu) ^ (seed * 0xC2B2AE35u);
}
__device__ __forceinline__ uint32_t hash2d_row(uint32_t iy, uint32_t lane) {
  uint32_t h = (iy * 0x9E3779B9u) ^ lane;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// u8 reads and writes go through int32, as the reference's int32 hop
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

// salt (255) or pepper (0) where the element's hash falls below thresh
__device__ __forceinline__ float salt_pepper(float v, uint32_t bits,
                                             uint32_t thresh) {
  return bits < thresh ? ((bits & 1u) ? 255.0f : 0.0f) : v;
}

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
// Lanes at or past w3 - 3 (pad lanes included) take themselves as their
// right neighbour, as the reference's lane masks do.
__device__ __forceinline__ int left_replicate(int x) { return x >= 3 ? x - 3 : x; }
__device__ __forceinline__ int right_replicate(int x, int w3) {
  return x < w3 - 3 ? x + 3 : x;
}

}  // namespace sap
