// Native polygon-IoU / polygon-NMS kernels (double precision, CPU).
//
// C twin of s2anet_tpu_torch/ops/polyiou.py — Sutherland–Hodgman clipping of
// convex polygons + shoelace area — serving the role the DOTA devkit's SWIG
// `polyiou` extension serves: the ground-truth IoU oracle for the VOC
// evaluator and the cross-chip merger, far faster than the NumPy loops.
// From the first #include on, a byte copy of s2anet_tpu/native/polyiou.cpp.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

inline double cross2(const Pt& a, const Pt& b) { return a.x * b.y - a.y * b.x; }

double signed_area(const Pt* p, int n) {
  double s = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& a = p[i];
    const Pt& b = p[(i + 1) % n];
    s += a.x * b.y - b.x * a.y;
  }
  return 0.5 * s;
}

// ensure CCW order into `out`; returns n
int ensure_ccw(const double* poly, int n, Pt* out) {
  for (int i = 0; i < n; ++i) out[i] = {poly[2 * i], poly[2 * i + 1]};
  if (signed_area(out, n) < 0) std::reverse(out, out + n);
  return n;
}

// Sutherland–Hodgman: clip `subj` by convex CCW `clip`; result in `out`.
// Buffers must hold >= 2*(ns+nc) points.
int clip_poly(const Pt* subj, int ns, const Pt* clip, int nc, Pt* out) {
  Pt bufA[64], bufB[64];
  int n = ns;
  std::memcpy(bufA, subj, sizeof(Pt) * ns);
  Pt* cur = bufA;
  Pt* nxt = bufB;
  for (int i = 0; i < nc && n > 0; ++i) {
    const Pt a = clip[i];
    const Pt b = clip[(i + 1) % nc];
    const Pt edge = {b.x - a.x, b.y - a.y};
    int m = 0;
    for (int j = 0; j < n; ++j) {
      const Pt& c = cur[j];
      const Pt& p = cur[(j + n - 1) % n];
      const double cin = cross2(edge, {c.x - a.x, c.y - a.y});
      const double pin = cross2(edge, {p.x - a.x, p.y - a.y});
      const bool c_in = cin >= 0, p_in = pin >= 0;
      if (c_in != p_in) {
        // intersection of segment p->c with the clip line a->b
        const Pt d1 = {c.x - p.x, c.y - p.y};
        const double denom = cross2(edge, d1);
        if (std::fabs(denom) > 1e-300) {
          const double t = cross2(edge, {p.x - a.x, p.y - a.y}) / -denom;
          nxt[m++] = {p.x + d1.x * t, p.y + d1.y * t};
        } else {
          nxt[m++] = c;
        }
      }
      if (c_in) nxt[m++] = c;
    }
    std::swap(cur, nxt);
    n = m;
  }
  std::memcpy(out, cur, sizeof(Pt) * n);
  return n;
}

double inter_area(const double* p1, int n1, const double* p2, int n2) {
  Pt a[32], b[32], out[64];
  int na = ensure_ccw(p1, n1, a);
  int nb = ensure_ccw(p2, n2, b);
  int m = clip_poly(a, na, b, nb, out);
  if (m < 3) return 0.0;
  return std::fabs(signed_area(out, m));
}

double poly_area_abs(const double* p, int n) {
  Pt a[32];
  ensure_ccw(p, n, a);
  return std::fabs(signed_area(a, n));
}

void rbox_vertices(const double* rb, double* poly8) {
  const double x = rb[0], y = rb[1], w = rb[2], h = rb[3], ang = rb[4];
  const double c2 = std::cos(ang) * 0.5, s2 = std::sin(ang) * 0.5;
  const double p0x = x - s2 * h - c2 * w, p0y = y + c2 * h - s2 * w;
  const double p1x = x + s2 * h - c2 * w, p1y = y - c2 * h - s2 * w;
  poly8[0] = p0x;
  poly8[1] = p0y;
  poly8[2] = p1x;
  poly8[3] = p1y;
  poly8[4] = 2 * x - p0x;
  poly8[5] = 2 * y - p0y;
  poly8[6] = 2 * x - p1x;
  poly8[7] = 2 * y - p1y;
}

}  // namespace

extern "C" {

// IoU of two convex polygons given as flat xy arrays with n1/n2 vertices.
double iou_poly(const double* p1, int n1, const double* p2, int n2) {
  const double a1 = poly_area_abs(p1, n1);
  const double a2 = poly_area_abs(p2, n2);
  const double inter = inter_area(p1, n1, p2, n2);
  const double uni = a1 + a2 - inter;
  if (uni <= 0) return 0.0;
  return inter / uni;
}

// Pairwise IoU of 4-vertex polygons: polys1 [n1,8], polys2 [n2,8] -> out [n1*n2].
void pairwise_poly_iou(const double* polys1, int64_t n1, const double* polys2,
                       int64_t n2, double* out) {
  for (int64_t i = 0; i < n1; ++i)
    for (int64_t j = 0; j < n2; ++j)
      out[i * n2 + j] = iou_poly(polys1 + 8 * i, 4, polys2 + 8 * j, 4);
}

// Pairwise IoU of rotated boxes (x,y,w,h,theta): b1 [n,5], b2 [m,5] -> out [n*m].
void rbox_iou_matrix(const double* b1, int64_t n, const double* b2, int64_t m,
                     double* out) {
  std::vector<double> v1(8 * n), v2(8 * m);
  for (int64_t i = 0; i < n; ++i) rbox_vertices(b1 + 5 * i, v1.data() + 8 * i);
  for (int64_t j = 0; j < m; ++j) rbox_vertices(b2 + 5 * j, v2.data() + 8 * j);
  for (int64_t i = 0; i < n; ++i) {
    const double a1 = b1[5 * i + 2] * b1[5 * i + 3];
    for (int64_t j = 0; j < m; ++j) {
      const double a2 = b2[5 * j + 2] * b2[5 * j + 3];
      if (a1 < 1e-14 || a2 < 1e-14) {
        out[i * m + j] = 0.0;
        continue;
      }
      const double inter = inter_area(v1.data() + 8 * i, 4, v2.data() + 8 * j, 4);
      out[i * m + j] = inter / (a1 + a2 - inter);
    }
  }
}

// Greedy polygon NMS with hbb prefilter (py_cpu_nms_poly_fast semantics):
// polys [n,8], scores [n]; writes kept indices into `keep`, returns count.
int64_t poly_nms(const double* polys, const double* scores, int64_t n,
                 double thresh, int64_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<double> x1(n), x2(n), y1(n), y2(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = polys + 8 * i;
    x1[i] = std::min(std::min(p[0], p[2]), std::min(p[4], p[6]));
    x2[i] = std::max(std::max(p[0], p[2]), std::max(p[4], p[6]));
    y1[i] = std::min(std::min(p[1], p[3]), std::min(p[5], p[7]));
    y2[i] = std::max(std::max(p[1], p[3]), std::max(p[5], p[7]));
  }
  std::vector<char> alive(n, 1);
  int64_t nk = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (!alive[i]) continue;
    keep[nk++] = i;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (!alive[j]) continue;
      const double iw = std::min(x2[i], x2[j]) - std::max(x1[i], x1[j]);
      const double ih = std::min(y2[i], y2[j]) - std::max(y1[i], y1[j]);
      if (iw <= 0 || ih <= 0) continue;
      if (iou_poly(polys + 8 * i, 4, polys + 8 * j, 4) > thresh) alive[j] = 0;
    }
  }
  return nk;
}

}  // extern "C"
