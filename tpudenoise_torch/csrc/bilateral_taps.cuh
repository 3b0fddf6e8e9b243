// The d=9 bilateral of a tile from a window in shared memory, shared by
// bilateral.cu (the standalone bilateral) and mix_noise.cu (the bilateral
// after the mixed noise), so the two cannot drift apart.
//
// As tpudenoise/denoise/pallas_bilateral.py:_bilateral_body computes it:
// the 49 taps of the disk dy^2 + dx^2 <= 16, dy outer, dx inner; one
// colour weight per tap, sw * exp((gc * d) * d) with d = (|dB| + |dG|) +
// |dR|; out = round(num / den), half to even.  The window holds zeros
// outside the image (BORDER_CONSTANT).  Built with --fmad=false, so each
// product and sum rounds where the plain torch version
// (denoise/bilateral.py:bilateral_plain) rounds.
//
// The kernel stages its window (`stage`: three float planes and a fourth
// of the values' bytes packed in one word), takes __syncthreads_and of
// "every staged value is a u8 value" and calls filter_tile, whose blocks
// then run one of two forms of the taps:
//   * table: every value is an integer in [0, 255], so d is an integer in
//     [0, 765] and exp((gc*d)*d) one of 766 values, which fill_lut
//     computes with the per-tap expression: a lookup gives the bits the
//     per-tap expf gives.  The packed word carries the values: d is one
//     byte-wise sum of absolute differences (__vsadu4) and each value a
//     byte turned float exactly, so a window position costs one load.
//   * expf: any other window (the [0, 1] floats of the gaussian kind, or
//     whatever a caller passes): the float planes, one expf per tap.
//
// Register reuse: each thread filters a strip of R pixels of one column.
// It walks the window one row at a time, and each value it loads serves
// every pixel of the strip with a tap on it; ascending window rows visit
// each pixel's taps in dy-outer, dx-inner order, so the sums keep their
// bits.  The loops unroll fully: a strip of 2 measured faster than 4 or 8
// on the card, whose code outgrows the instruction cache.  The spatial
// weights are a kernel parameter (Weights, by value): the unrolled loop
// reads each from the parameter bank with no load of its own.

#pragma once

#include <math.h>
#include <stdint.h>

namespace bilateral_taps {

constexpr int kRadius = 4;   // d = 9
constexpr int kTaps = 49;
constexpr int kLut = 766;    // d of a u8 window: 0 .. 3 * 255

// the spatial weights in tap order
struct Weights {
  float v[kTaps];
};

__host__ __device__ constexpr bool in_disk(int dy, int dx) {
  return dy * dy + dx * dx <= kRadius * kRadius;
}

// position of tap (dy, dx) in the disk's dy-outer, dx-inner order
__host__ __device__ constexpr int tap_index(int dy, int dx) {
  int k = 0;
  for (int y = -kRadius; y <= kRadius; ++y)
    for (int x = -kRadius; x <= kRadius; ++x) {
      if (!in_disk(y, x)) continue;
      if (y == dy && x == dx) return k;
      ++k;
    }
  return -1;
}

static_assert(tap_index(kRadius, 0) == kTaps - 1, "49-tap disk");

// lut[i] = expf((gc * i) * i), the per-tap expression at d = i
__device__ __forceinline__ void fill_lut(float* lut, float gc) {
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    const float d = (float)i;
    lut[i] = expf((gc * d) * d);
  }
}

// lut[d], lut given as its shared-memory address: one shift-add and the
// load
__device__ __forceinline__ float lut_at(uint32_t lut, uint32_t d) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(lut + (d << 2)));
  return v;
}

// v is a u8 value: integral and in [0, 255] (false for NaN)
__device__ __forceinline__ bool is_u8(float v) {
  return rintf(v) == v && v >= 0.0f && v <= 255.0f;
}

// byte i of q as a float: 2^23 + byte, less 2^23 (exact; a staged -0.0
// comes back +0.0, which changes no sum: num starts at +0.0)
__device__ __forceinline__ float byte_value(uint32_t q, int i) {
  return __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7650 + i)) - 0x1p23f;
}

// Stage window position (wy, wx) of win[4][WinH][WinW]: the (B, G, R)
// values in planes 0-2 and, in plane 3, their low bytes packed into one
// word, from which the table form takes d as a byte-wise sum of absolute
// differences.  Returns whether the three are u8 values (then the bytes
// are the values and that d is the float d).
template <int WinH, int WinW>
__device__ __forceinline__ bool stage(float (*win)[WinH][WinW], int wy,
                                      int wx, const float v[3]) {
  uint32_t packed = 0;
  bool u8 = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    win[c][wy][wx] = v[c];
    packed |= (__float2uint_rz(v[c]) & 0xFFu) << (8 * c);
    u8 = u8 & is_u8(v[c]);
  }
  win[3][wy][wx] = __uint_as_float(packed);
  return u8;
}

// The R pixels (wy + p, wx), p < R, of a window staged by `stage`
// (window coordinates, at least kRadius from its edges) -> out[p][c];
// lut: the table's shared-memory address.
template <int R, bool kTable, int WinH, int WinW>
__device__ __forceinline__ void strip(const float (*win)[WinH][WinW], int wy,
                                      int wx, const Weights& sw, float gc,
                                      uint32_t lut, float (&out)[R][3]) {
  float c[R][3], num[R][3], den[R];
  uint32_t cq[R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c[p][ch] = win[ch][wy + p][wx];
      num[p][ch] = 0.0f;
    }
    cq[p] = __float_as_uint(win[3][wy + p][wx]);
    den[p] = 0.0f;
  }
#pragma unroll
  for (int r = -kRadius; r < R + kRadius; ++r) {   // window row wy + r
#pragma unroll
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      // loads no pixel of the strip needs are dead code; the table form
      // reads only the packed word (its bytes are the values)
      const uint32_t q = __float_as_uint(win[3][wy + r][wx + dx]);
      const float v0 = kTable ? byte_value(q, 0) : win[0][wy + r][wx + dx];
      const float v1 = kTable ? byte_value(q, 1) : win[1][wy + r][wx + dx];
      const float v2 = kTable ? byte_value(q, 2) : win[2][wy + r][wx + dx];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        const int dy = r - p;
        if (dy < -kRadius || dy > kRadius || !in_disk(dy, dx)) continue;
        float e;
        if (kTable) {   // u8 values: d = |dB| + |dG| + |dR| exactly
          e = lut_at(lut, __vsadu4(q, cq[p]));
        } else {
          const float d = (fabsf(v0 - c[p][0]) + fabsf(v1 - c[p][1])) +
                          fabsf(v2 - c[p][2]);
          e = expf((gc * d) * d);
        }
        const float wgt = sw.v[tap_index(dy, dx)] * e;
        num[p][0] = num[p][0] + wgt * v0;
        num[p][1] = num[p][1] + wgt * v1;
        num[p][2] = num[p][2] + wgt * v2;
        den[p] = den[p] + wgt;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[p][ch] = rintf(num[p][ch] / den[p]);
}

// Filter the TileH x TileW tile at (r0, c0) of image b from its staged
// window (tile plus a kRadius halo) into out (B, h, w, 3) f32, in strips
// of R pixels; the threads of a warp take neighbouring columns.
template <int TileH, int TileW, int R, int WinH, int WinW>
__device__ __forceinline__ void filter_tile(const float (*win)[WinH][WinW],
                                            bool table, const Weights& sw,
                                            float gc, const float* lut,
                                            float* __restrict__ out, int b,
                                            int h, int w, int r0, int c0) {
  static_assert(TileH % R == 0, "strips tile the tile");
  static_assert(WinH == TileH + 2 * kRadius && WinW == TileW + 2 * kRadius,
                "window = tile + halo");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(lut);
  for (int s = threadIdx.x; s < TileW * (TileH / R); s += blockDim.x) {
    const int tx = s % TileW, ty = s / TileW * R;
    const int x = c0 + tx, y0 = r0 + ty;
    if (x >= w || y0 >= h) continue;
    float o[R][3];
    if (table)
      strip<R, true>(win, ty + kRadius, tx + kRadius, sw, gc, base, o);
    else
      strip<R, false>(win, ty + kRadius, tx + kRadius, sw, gc, base, o);
#pragma unroll
    for (int p = 0; p < R; ++p) {
      if (y0 + p >= h) break;
      const size_t e = (((size_t)b * h + y0 + p) * w + x) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[e + ch] = o[p][ch];
    }
  }
}

// Bytes of dynamic shared memory: the window's four planes, then the
// table.
constexpr int smem_bytes(int win_h, int win_w) {
  return (4 * win_h * win_w + kLut) * (int)sizeof(float);
}

}  // namespace bilateral_taps
