// The sun-flare ("bloom") compositing of one pixel, shared by bloom.cu
// (kernel for bloom plans) and mix_noise.cu (the bloom kind of a mix).
//
// 48 overlay/output steps from per-step scalars (cx, cy, r^2, b, g, r,
// alpha, 0) that generators.bloom_params draws outside the kernels, as
// tpudenoise/noise/pallas_bloom.py:_bloom_kernel computes them.  Steps 8
// and later are the flare-source rings; they share one centre, so their
// squared distance is computed once.  Each step rounds half to even and
// clamps to [0, 255].  Built with --fmad=false, so alpha*overlay +
// (1-alpha)*output rounds as the plain torch version's separate ops do.

#pragma once

namespace bloom_steps {

constexpr int kSteps = 48;   // compositing steps
constexpr int kCirc = 8;     // steps with their own centre

// cv2 saturate_cast<uchar>: round half-even, clamp (NaN kept, as jnp.clip)
__device__ __forceinline__ float sat_u8(float x) {
  const float r = rintf(x);
  return r != r ? r : fminf(fmaxf(r, 0.0f), 255.0f);
}

// prm: the image's (kSteps, 8) params; (xx, yy): the pixel's column and
// row; in[3] -> out[3].
__device__ __forceinline__ void composite(const float* prm, float xx,
                                          float yy, const float in[3],
                                          float out[3]) {
  const float sx = xx - prm[kCirc * 8 + 0], sy = yy - prm[kCirc * 8 + 1];
  const float dsrc = sx * sx + sy * sy;
  float overlay[3];
  for (int c = 0; c < 3; ++c) overlay[c] = out[c] = in[c];
  for (int s = 0; s < kSteps; ++s) {
    const float* q = prm + 8 * s;
    bool mask;
    if (s < kCirc) {
      const float dx = xx - q[0], dy = yy - q[1];
      mask = dx * dx + dy * dy <= q[2];
    } else {
      mask = dsrc <= q[2];
    }
    const float alpha = q[6];
    for (int c = 0; c < 3; ++c) {
      if (mask) overlay[c] = q[3 + c];
      out[c] = sat_u8(alpha * overlay[c] + (1.0f - alpha) * out[c]);
    }
  }
}

}  // namespace bloom_steps
