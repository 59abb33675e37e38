// Planar Delaunay triangulation with barycentric point location, and an
// exact grid-bucketed nearest-neighbour query: the host half of the exact
// 'tri' hole fill (fovealseg_torch/native/interp2d.py). The port's own copy
// of the three entry points of fovealseg_tpu/native/spatial.cpp that 'tri'
// uses, unchanged, so that both packages build the same plan.
//
// Built at first use by fovealseg_torch/native/spatial.py with
//   g++ -O3 -fPIC -std=c++17 -shared
// and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Tri {
  int a, b, c;      // vertex indices (negative: super-triangle virtual verts)
  double cx, cy, r2;  // circumcircle
  bool alive;
};

inline void circumcircle(double ax, double ay, double bx, double by, double cx,
                         double cy, double* ox, double* oy, double* r2) {
  double d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by));
  if (std::fabs(d) < 1e-30) {
    *ox = *oy = 0.0;
    *r2 = std::numeric_limits<double>::infinity();
    return;
  }
  double a2 = ax * ax + ay * ay, b2 = bx * bx + by * by, c2 = cx * cx + cy * cy;
  *ox = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d;
  *oy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d;
  double dx = ax - *ox, dy = ay - *oy;
  *r2 = dx * dx + dy * dy;
}

}  // namespace

extern "C" {

// Bowyer-Watson Delaunay triangulation of n 2-D points.
// points: [n*2] doubles (x, y). out_tris: caller buffer [max_tris*3] int32.
// Returns number of triangles (or -1 if the buffer is too small).
int delaunay_triangulate(const double* points, int n, int32_t* out_tris,
                         int max_tris) {
  if (n < 3) return 0;
  double minx = points[0], maxx = points[0], miny = points[1], maxy = points[1];
  for (int i = 0; i < n; i++) {
    minx = std::min(minx, points[2 * i]);
    maxx = std::max(maxx, points[2 * i]);
    miny = std::min(miny, points[2 * i + 1]);
    maxy = std::max(maxy, points[2 * i + 1]);
  }
  double dmax = std::max(maxx - minx, maxy - miny) + 1.0;
  double midx = 0.5 * (minx + maxx), midy = 0.5 * (miny + maxy);
  // virtual super-triangle vertices (indices n, n+1, n+2)
  std::vector<double> px(n + 3), py(n + 3);
  for (int i = 0; i < n; i++) {
    px[i] = points[2 * i];
    py[i] = points[2 * i + 1];
  }
  px[n] = midx - 3e4 * dmax;  py[n] = midy - 1e4 * dmax;
  px[n + 1] = midx;          py[n + 1] = midy + 3e4 * dmax;
  px[n + 2] = midx + 3e4 * dmax; py[n + 2] = midy - 1e4 * dmax;

  std::vector<Tri> tris;
  tris.reserve(2 * n + 8);
  {
    Tri t{n, n + 1, n + 2, 0, 0, 0, true};
    circumcircle(px[t.a], py[t.a], px[t.b], py[t.b], px[t.c], py[t.c], &t.cx,
                 &t.cy, &t.r2);
    tris.push_back(t);
  }

  std::vector<std::pair<int, int>> edges;
  for (int i = 0; i < n; i++) {
    double x = px[i], y = py[i];
    edges.clear();
    for (auto& t : tris) {
      if (!t.alive) continue;
      double dx = x - t.cx, dy = y - t.cy;
      if (dx * dx + dy * dy <= t.r2 * (1.0 + 1e-12)) {
        t.alive = false;
        edges.push_back({t.a, t.b});
        edges.push_back({t.b, t.c});
        edges.push_back({t.c, t.a});
      }
    }
    // boundary edges appear exactly once (unordered)
    for (size_t e = 0; e < edges.size(); e++) {
      bool dup = false;
      for (size_t f = 0; f < edges.size(); f++) {
        if (e == f) continue;
        if ((edges[e].first == edges[f].second &&
             edges[e].second == edges[f].first) ||
            (edges[e].first == edges[f].first &&
             edges[e].second == edges[f].second)) {
          dup = true;
          break;
        }
      }
      if (dup) continue;
      Tri t{edges[e].first, edges[e].second, i, 0, 0, 0, true};
      circumcircle(px[t.a], py[t.a], px[t.b], py[t.b], px[t.c], py[t.c], &t.cx,
                   &t.cy, &t.r2);
      tris.push_back(t);
    }
    // periodic compaction keeps the cavity scan O(live)
    if (tris.size() > 4096 && i % 256 == 255) {
      std::vector<Tri> keep;
      keep.reserve(tris.size());
      for (auto& t : tris)
        if (t.alive) keep.push_back(t);
      tris.swap(keep);
    }
  }

  int count = 0;
  for (auto& t : tris) {
    if (!t.alive) continue;
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-tri
    if (count >= max_tris) return -1;
    out_tris[3 * count] = t.a;
    out_tris[3 * count + 1] = t.b;
    out_tris[3 * count + 2] = t.c;
    count++;
  }
  return count;
}

// Point location with barycentric output (the qhull.pyx find_simplex
// return_c=True capability). Queries q points against m triangles using a
// uniform-grid index over triangle bboxes. For query j:
//   out_simplex[j] = triangle index or -1;
//   out_bary[j*3..] = barycentric coords in that triangle.
void find_simplex_bary(const double* points, int n, const int32_t* tris, int m,
                       const double* queries, int q, int32_t* out_simplex,
                       double* out_bary, double tol) {
  if (m == 0) {
    for (int j = 0; j < q; j++) out_simplex[j] = -1;
    return;
  }
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int i = 0; i < n; i++) {
    minx = std::min(minx, points[2 * i]);
    maxx = std::max(maxx, points[2 * i]);
    miny = std::min(miny, points[2 * i + 1]);
    maxy = std::max(maxy, points[2 * i + 1]);
  }
  int gs = std::max(1, (int)std::sqrt((double)m));
  double sx = (maxx - minx) / gs + 1e-12, sy = (maxy - miny) / gs + 1e-12;
  auto cell = [&](double x, double y, int* cx, int* cy) {
    *cx = std::min(gs - 1, std::max(0, (int)((x - minx) / sx)));
    *cy = std::min(gs - 1, std::max(0, (int)((y - miny) / sy)));
  };
  std::vector<std::vector<int>> buckets(gs * gs);
  for (int t = 0; t < m; t++) {
    double tminx = 1e300, tmaxx = -1e300, tminy = 1e300, tmaxy = -1e300;
    for (int k = 0; k < 3; k++) {
      int v = tris[3 * t + k];
      tminx = std::min(tminx, points[2 * v]);
      tmaxx = std::max(tmaxx, points[2 * v]);
      tminy = std::min(tminy, points[2 * v + 1]);
      tmaxy = std::max(tmaxy, points[2 * v + 1]);
    }
    int c0x, c0y, c1x, c1y;
    cell(tminx, tminy, &c0x, &c0y);
    cell(tmaxx, tmaxy, &c1x, &c1y);
    for (int cy = c0y; cy <= c1y; cy++)
      for (int cx = c0x; cx <= c1x; cx++) buckets[cy * gs + cx].push_back(t);
  }
  for (int j = 0; j < q; j++) {
    double x = queries[2 * j], y = queries[2 * j + 1];
    int cx, cy;
    cell(x, y, &cx, &cy);
    out_simplex[j] = -1;
    for (int t : buckets[cy * gs + cx]) {
      int a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
      double ax = points[2 * a], ay = points[2 * a + 1];
      double bx = points[2 * b], by = points[2 * b + 1];
      double ccx = points[2 * c], ccy = points[2 * c + 1];
      double det = (by - ccy) * (ax - ccx) + (ccx - bx) * (ay - ccy);
      if (std::fabs(det) < 1e-30) continue;
      double l1 = ((by - ccy) * (x - ccx) + (ccx - bx) * (y - ccy)) / det;
      double l2 = ((ccy - ay) * (x - ccx) + (ax - ccx) * (y - ccy)) / det;
      double l3 = 1.0 - l1 - l2;
      if (l1 >= -tol && l2 >= -tol && l3 >= -tol) {
        out_simplex[j] = t;
        out_bary[3 * j] = l1;
        out_bary[3 * j + 1] = l2;
        out_bary[3 * j + 2] = l3;
        break;
      }
    }
  }
}

// Grid-bucketed exact nearest neighbor (ckdtree-equivalent for 2-D):
// for each query, index of the nearest of n points (Euclidean).
void nearest_neighbor(const double* points, int n, const double* queries,
                      int q, int32_t* out_idx) {
  if (n == 0) {
    for (int j = 0; j < q; j++) out_idx[j] = -1;
    return;
  }
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int i = 0; i < n; i++) {
    minx = std::min(minx, points[2 * i]);
    maxx = std::max(maxx, points[2 * i]);
    miny = std::min(miny, points[2 * i + 1]);
    maxy = std::max(maxy, points[2 * i + 1]);
  }
  int gs = std::max(1, (int)std::sqrt((double)n / 2.0));
  double sx = (maxx - minx) / gs + 1e-12, sy = (maxy - miny) / gs + 1e-12;
  auto cellx = [&](double x) {
    return std::min(gs - 1, std::max(0, (int)((x - minx) / sx)));
  };
  auto celly = [&](double y) {
    return std::min(gs - 1, std::max(0, (int)((y - miny) / sy)));
  };
  std::vector<std::vector<int>> buckets(gs * gs);
  for (int i = 0; i < n; i++)
    buckets[celly(points[2 * i + 1]) * gs + cellx(points[2 * i])].push_back(i);

  for (int j = 0; j < q; j++) {
    double x = queries[2 * j], y = queries[2 * j + 1];
    int cx = cellx(x), cy = celly(y);
    double best = 1e300;
    int bi = -1;
    for (int ring = 0; ring < gs + 1; ring++) {
      bool any = false;
      for (int dy = -ring; dy <= ring; dy++) {
        for (int dx = -ring; dx <= ring; dx++) {
          if (std::max(std::abs(dx), std::abs(dy)) != ring) continue;
          int ux = cx + dx, uy = cy + dy;
          if (ux < 0 || uy < 0 || ux >= gs || uy >= gs) continue;
          any = true;
          for (int i : buckets[uy * gs + ux]) {
            double ddx = points[2 * i] - x, ddy = points[2 * i + 1] - y;
            double d = ddx * ddx + ddy * ddy;
            if (d < best) {
              best = d;
              bi = i;
            }
          }
        }
      }
      // safe stop: nearest point can be at most one ring beyond the first
      // ring where a candidate was found
      if (bi >= 0) {
        double ring_dist = (double)ring * std::min(sx, sy);
        if (best <= ring_dist * ring_dist || ring == gs) break;
      }
      if (!any && ring > 2 * gs) break;
    }
    out_idx[j] = bi;
  }
}

}  // extern "C"
