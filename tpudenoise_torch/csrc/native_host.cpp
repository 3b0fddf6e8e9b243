// Host C++ kernels of the port's host-side box ops (a copy of the JAX
// package's native/tpudenoise_native.cpp, which the port may not use):
// greedy NMS over saved detections (cli.reval --device cpu under
// cfg.USE_NATIVE_NMS), the IoU matrix and the box decode.  C ABI, loaded
// with ctypes by tpudenoise_torch/ops/native.py, which builds this file
// with the host compiler at first use (c++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy NMS over score-sorted candidates.
//   dets: n rows of (x1, y1, x2, y2, score), any order.
//   keep_out: caller-allocated int32[n]; returns number kept.
// Matches py_cpu_nms (IoU with the +1 convention, strict > threshold
// suppression, descending-score order with index tiebreak).
int tpud_nms(const float* dets, int n, float thresh, int32_t* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + 1.f) * (d[3] - d[1] + 1.f);
  }
  std::vector<char> suppressed(n, 0);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* di = dets + i * 5;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      float xx1 = std::max(di[0], dj[0]);
      float yy1 = std::max(di[1], dj[1]);
      float xx2 = std::min(di[2], dj[2]);
      float yy2 = std::min(di[3], dj[3]);
      float w = std::max(0.f, xx2 - xx1 + 1.f);
      float h = std::max(0.f, yy2 - yy1 + 1.f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// N x K IoU matrix with the +1 convention (ref lib/utils/bbox.pyx:15-55).
//   boxes: (n, 4); query: (k, 4); out: (n, k) row-major.
void tpud_bbox_overlaps(const float* boxes, int n, const float* query,
                        int k, float* out) {
  for (int kk = 0; kk < k; ++kk) {
    const float* q = query + kk * 4;
    const float qa = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
    for (int nn = 0; nn < n; ++nn) {
      const float* b = boxes + nn * 4;
      float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      float out_v = 0.f;
      if (iw > 0.f) {
        float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
        if (ih > 0.f) {
          float ua =
              (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f) + qa - iw * ih;
          out_v = iw * ih / ua;
        }
      }
      out[nn * k + kk] = out_v;
    }
  }
}

// Decode box deltas onto anchors (bbox_transform_inv, single class).
//   boxes: (n, 4); deltas: (n, 4); out: (n, 4).
void tpud_bbox_decode(const float* boxes, const float* deltas, int n,
                      float* out) {
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + i * 4;
    const float* d = deltas + i * 4;
    float w = b[2] - b[0] + 1.f;
    float h = b[3] - b[1] + 1.f;
    float cx = b[0] + 0.5f * w;
    float cy = b[1] + 0.5f * h;
    float pcx = d[0] * w + cx;
    float pcy = d[1] * h + cy;
    float pw = std::exp(d[2]) * w;
    float ph = std::exp(d[3]) * h;
    float* o = out + i * 4;
    o[0] = pcx - 0.5f * pw;
    o[1] = pcy - 0.5f * ph;
    o[2] = pcx + 0.5f * pw;
    o[3] = pcy + 0.5f * ph;
  }
}

}  // extern "C"
