// The d=9 bilateral of one pixel from a planar window in shared memory,
// shared by bilateral.cu (the standalone bilateral) and mix_noise.cu (the
// bilateral after the mixed noise), so the two cannot drift apart.
//
// As tpudenoise/denoise/pallas_bilateral.py:_bilateral_body computes it:
// the 49 taps of the disk dy^2 + dx^2 <= 16, dy outer, dx inner; one
// colour weight per tap, sw * exp((gc * d) * d) with d = (|dB| + |dG|) +
// |dR|; out = round(num / den), half to even.  The window holds zeros
// outside the image (BORDER_CONSTANT).  Built with --fmad=false, so each
// product and sum rounds where the plain torch version
// (denoise/bilateral.py:bilateral_plain) rounds.

#pragma once

namespace bilateral_taps {

constexpr int kRadius = 4;   // d = 9
constexpr int kTaps = 49;

// win: [3][WinH][WinW]; (wy, wx): the pixel's window position, at least
// kRadius from the window's edges; sw: the kTaps spatial weights in tap
// order; gc: -0.5 / sigma_color^2 as f32.
template <int WinH, int WinW>
__device__ void pixel(const float (*win)[WinH][WinW], int wy, int wx,
                      const float* sw, float gc, float out[3]) {
  const float c0 = win[0][wy][wx], c1 = win[1][wy][wx], c2 = win[2][wy][wx];
  float num[3] = {0.0f, 0.0f, 0.0f};
  float den = 0.0f;
  int k = 0;
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (dy * dy + dx * dx > kRadius * kRadius) continue;
      const float v0 = win[0][wy + dy][wx + dx];
      const float v1 = win[1][wy + dy][wx + dx];
      const float v2 = win[2][wy + dy][wx + dx];
      const float d = (fabsf(v0 - c0) + fabsf(v1 - c1)) + fabsf(v2 - c2);
      const float wgt = sw[k++] * expf((gc * d) * d);
      num[0] = num[0] + wgt * v0;
      num[1] = num[1] + wgt * v1;
      num[2] = num[2] + wgt * v2;
      den = den + wgt;
    }
  }
  for (int c = 0; c < 3; ++c) out[c] = rintf(num[c] / den);
}

}  // namespace bilateral_taps
