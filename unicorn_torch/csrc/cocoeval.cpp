// COCOeval's matcher, native: the per-(image, category) greedy matching of
// detections to ground truth at T IoU thresholds (a copy of
// unicorn_tpu/csrc/cocoeval.cpp), bound by unicorn_torch/csrc/native.py
// with ctypes. unicorn_torch/evaluators/coco_map.py keeps the Python loop
// as the plain reference the tests hold this against.
//
// The role of the reference's C++ COCOeval
// (unicorn/layers/csrc/cocoeval/cocoeval.cpp): this loop is the only part of
// COCO evaluation that is O(T*D*G) scalar work; the rest stays numpy.
#include <cstdint>
#include <cstring>

extern "C" {

// ious:        D x G row-major IoU matrix (gts already sorted: non-ignored
//              first — mirrors COCOeval's gtind sort)
// gt_ignore:   G flags (after sorting)
// gt_iscrowd:  G flags (after sorting)
// thresholds:  T IoU thresholds
// dt_match:    T x D output, matched (sorted) gt index or -1
// dt_ignore:   T x D output flags
void cocoeval_evaluate_img(const double* ious, int64_t D, int64_t G,
                           const uint8_t* gt_ignore, const uint8_t* gt_iscrowd,
                           const double* thresholds, int64_t T,
                           int64_t* dt_match, uint8_t* dt_ignore) {
  // gt_match is per-threshold bookkeeping
  int64_t* gt_match = new int64_t[G];
  for (int64_t t = 0; t < T; ++t) {
    for (int64_t g = 0; g < G; ++g) gt_match[g] = -1;
    const double thr = thresholds[t];
    for (int64_t d = 0; d < D; ++d) {
      double best_iou = thr < (1.0 - 1e-10) ? thr : (1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t g = 0; g < G; ++g) {
        // already matched (crowd gt can match many dets)
        if (gt_match[g] >= 0 && !gt_iscrowd[g]) continue;
        // best non-ignored match found and remaining gts are ignored: stop
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        const double iou = ious[d * G + g];
        if (iou < best_iou) continue;
        best_iou = iou;
        m = g;
      }
      if (m == -1) continue;
      dt_ignore[t * D + d] = gt_ignore[m];
      dt_match[t * D + d] = m;
      gt_match[m] = d;
    }
  }
  delete[] gt_match;
}

}  // extern "C"
