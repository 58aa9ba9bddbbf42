// COCO bbox evaluation inner loop, C++ (the port's copy of the JAX
// package's native/coco_eval.cc; the code below is that file's).
//
// The protocol logic lives in Python (evaluation/coco_metrics.py); this
// translation unit provides the O(n_thr * n_dt * n_gt) greedy matching +
// IoU kernel, loaded with ctypes by evaluation/native.py, which builds it
// with g++ at first use (utils/host_lib.py). The numpy implementation stays
// as the reference; tests/test_torch_native.py holds the two equal.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// IoU of xywh boxes; crowd GT uses the detection area as the union
// (pycocotools maskUtils.iou semantics).
inline double iou_xywh(const double* d, const double* g, bool crowd) {
  const double dx1 = d[0], dy1 = d[1], dx2 = d[0] + d[2], dy2 = d[1] + d[3];
  const double gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
  const double iw = std::max(0.0, std::min(dx2, gx2) - std::max(dx1, gx1));
  const double ih = std::max(0.0, std::min(dy2, gy2) - std::max(dy1, gy1));
  const double inter = iw * ih;
  const double d_area = d[2] * d[3];
  const double g_area = g[2] * g[3];
  const double uni = crowd ? d_area : d_area + g_area - inter;
  if (uni <= 0.0) return 0.0;
  return inter / uni;
}

}  // namespace

extern "C" {

// Greedy per-detection matching for one (image, category) cell.
//
// Inputs (detections MUST already be sorted by descending score and
// truncated to max_det; GT MUST already be sorted non-ignored-first —
// the Python wrapper does both):
//   dt_boxes   [n_dt, 4] xywh
//   gt_boxes   [n_gt, 4] xywh
//   gt_ignore  [n_gt]    0/1
//   gt_crowd   [n_gt]    0/1
//   iou_thrs   [n_thr]
//   area_lo, area_hi     detection area range for the unmatched-ignore rule
// Outputs (caller-allocated):
//   dtm        [n_thr, n_dt]  matched gt index + 1 (0 = unmatched)
//   dt_ignore  [n_thr, n_dt]  0/1
void cocoeval_match_cell(const double* dt_boxes, int64_t n_dt,
                         const double* gt_boxes, const int32_t* gt_ignore,
                         const int32_t* gt_crowd, int64_t n_gt,
                         const double* iou_thrs, int64_t n_thr,
                         double area_lo, double area_hi,
                         int64_t* dtm, uint8_t* dt_ignore_out) {
  // Precompute the IoU table once per cell.
  std::vector<double> ious(static_cast<size_t>(n_dt * n_gt));
  for (int64_t di = 0; di < n_dt; ++di) {
    for (int64_t gi = 0; gi < n_gt; ++gi) {
      ious[di * n_gt + gi] =
          iou_xywh(dt_boxes + 4 * di, gt_boxes + 4 * gi, gt_crowd[gi] != 0);
    }
  }

  std::vector<int64_t> gtm(static_cast<size_t>(n_gt));
  for (int64_t ti = 0; ti < n_thr; ++ti) {
    std::fill(gtm.begin(), gtm.end(), 0);
    int64_t* dtm_t = dtm + ti * n_dt;
    uint8_t* dtig_t = dt_ignore_out + ti * n_dt;
    for (int64_t di = 0; di < n_dt; ++di) {
      double best = std::min(iou_thrs[ti], 1.0 - 1e-10);
      int64_t m = -1;
      for (int64_t gi = 0; gi < n_gt; ++gi) {
        if (gtm[gi] > 0 && !gt_crowd[gi]) continue;
        // Once holding a non-ignored match, ignored GT (sorted last)
        // cannot improve it.
        if (m > -1 && gt_ignore[m] == 0 && gt_ignore[gi] == 1) break;
        const double iou = ious[di * n_gt + gi];
        if (iou < best) continue;
        best = iou;
        m = gi;
      }
      if (m == -1) {
        dtm_t[di] = 0;
        dtig_t[di] = 0;
        continue;
      }
      dtig_t[di] = static_cast<uint8_t>(gt_ignore[m]);
      dtm_t[di] = m + 1;
      gtm[m] = di + 1;
    }
    // Unmatched detections outside the area range are ignored.
    for (int64_t di = 0; di < n_dt; ++di) {
      if (dtm_t[di] == 0) {
        const double area = dt_boxes[4 * di + 2] * dt_boxes[4 * di + 3];
        if (area < area_lo || area > area_hi) dtig_t[di] = 1;
      }
    }
  }
}

// Batched per-category matching: all images of one category in one call.
//
// Mirrors pycocotools' evaluate() structure: the dt x gt IoU table is
// computed ONCE per image and reused across every area range (the 3
// maxDets are handled downstream in accumulate by column truncation, so
// matching always runs at the maxDet cap). This removes both the 12x
// redundant IoU+matching work of a naive per-(area,maxDet) loop and the
// per-cell Python/ctypes call overhead.
//
// Inputs (per-image segments, concatenated):
//   dt_boxes  [total_dt, 4] xywh — sorted by descending score WITHIN each
//             image and truncated to the maxDet cap (Python does both)
//   dt_off    [n_img + 1] segment offsets into dt_boxes
//   gt_boxes  [total_gt, 4] xywh (original annotation order)
//   gt_crowd  [total_gt] 0/1
//   gt_area   [total_gt] annotation 'area' (ignore-rule input)
//   gt_off    [n_img + 1]
//   iou_thrs  [n_thr]
//   area_rngs [n_area, 2] (lo, hi)
// Outputs (caller-allocated):
//   dtm        [n_area, n_thr, total_dt] matched sorted-gt index + 1
//   dt_ignore  [n_area, n_thr, total_dt] 0/1
//   num_gt_out [n_area] non-ignored GT count summed over images
void cocoeval_match_category(const double* dt_boxes, const int64_t* dt_off,
                             const double* gt_boxes, const int32_t* gt_crowd,
                             const double* gt_area, const int64_t* gt_off,
                             int64_t n_img, const double* iou_thrs,
                             int64_t n_thr, const double* area_rngs,
                             int64_t n_area, int32_t* dtm,
                             uint8_t* dt_ignore_out, int32_t* num_gt_out) {
  const int64_t total_dt = dt_off[n_img];
  for (int64_t a = 0; a < n_area; ++a) num_gt_out[a] = 0;

  std::vector<double> ious;
  std::vector<int64_t> order;
  std::vector<int64_t> gtm;
  std::vector<uint8_t> gig;        // per-gt ignore, original order
  std::vector<uint8_t> sg_ig;      // per-gt ignore, sorted order

  for (int64_t im = 0; im < n_img; ++im) {
    const int64_t d0 = dt_off[im], nd = dt_off[im + 1] - d0;
    const int64_t g0 = gt_off[im], ng = gt_off[im + 1] - g0;
    if (nd == 0 && ng == 0) continue;

    // IoU table once per image (crowd semantics baked in).
    ious.assign(static_cast<size_t>(nd * ng), 0.0);
    for (int64_t di = 0; di < nd; ++di)
      for (int64_t gi = 0; gi < ng; ++gi)
        ious[di * ng + gi] = iou_xywh(dt_boxes + 4 * (d0 + di),
                                      gt_boxes + 4 * (g0 + gi),
                                      gt_crowd[g0 + gi] != 0);

    for (int64_t a = 0; a < n_area; ++a) {
      const double lo = area_rngs[2 * a], hi = area_rngs[2 * a + 1];
      gig.assign(static_cast<size_t>(ng), 0);
      int64_t n_keep = 0;
      for (int64_t gi = 0; gi < ng; ++gi) {
        const bool ig = gt_crowd[g0 + gi] != 0 || gt_area[g0 + gi] < lo ||
                        gt_area[g0 + gi] > hi;
        gig[gi] = ig ? 1 : 0;
        if (!ig) ++n_keep;
      }
      num_gt_out[a] += static_cast<int32_t>(n_keep);

      // Stable sort: non-ignored GT first (pycocotools gtind).
      order.resize(static_cast<size_t>(ng));
      for (int64_t gi = 0; gi < ng; ++gi) order[gi] = gi;
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t x, int64_t y) { return gig[x] < gig[y]; });
      sg_ig.resize(static_cast<size_t>(ng));
      for (int64_t oi = 0; oi < ng; ++oi) sg_ig[oi] = gig[order[oi]];

      gtm.assign(static_cast<size_t>(ng), 0);
      for (int64_t ti = 0; ti < n_thr; ++ti) {
        std::fill(gtm.begin(), gtm.end(), 0);
        int32_t* dtm_t = dtm + (a * n_thr + ti) * total_dt + d0;
        uint8_t* dtig_t = dt_ignore_out + (a * n_thr + ti) * total_dt + d0;
        for (int64_t di = 0; di < nd; ++di) {
          double best = std::min(iou_thrs[ti], 1.0 - 1e-10);
          int64_t m = -1;
          for (int64_t oi = 0; oi < ng; ++oi) {
            const int64_t gi = order[oi];
            if (gtm[oi] > 0 && gt_crowd[g0 + gi] == 0) continue;
            if (m > -1 && sg_ig[m] == 0 && sg_ig[oi] == 1) break;
            const double iou = ious[di * ng + gi];
            if (iou < best) continue;
            best = iou;
            m = oi;
          }
          if (m == -1) {
            dtm_t[di] = 0;
            dtig_t[di] = 0;
            const double area =
                dt_boxes[4 * (d0 + di) + 2] * dt_boxes[4 * (d0 + di) + 3];
            if (area < lo || area > hi) dtig_t[di] = 1;
            continue;
          }
          dtig_t[di] = sg_ig[m];
          dtm_t[di] = static_cast<int32_t>(m + 1);
          gtm[m] = di + 1;
        }
      }
    }
  }
}

}  // extern "C"
