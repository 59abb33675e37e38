// k-d tree: k-NN query, ball query, pair counting. The port's copy of
// fovealseg_tpu/native/kdtree.cpp, unchanged below this note: a median-split
// tree (any dimension, minkowski-p metric, brute force in the leaves) behind
// a handle-based C interface. Built into the port's one native library by
// fovealseg_torch/native/spatial.py and called through ctypes from
// native/kdtree.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr int kLeafSize = 16;

struct Node {
  int left = -1, right = -1;   // child node ids (-1: leaf)
  int begin = 0, end = 0;      // index range into `order` (leaves)
  int axis = 0;
  double split = 0.0;
  // bounding box of the points under this node
  std::vector<double> lo, hi;
};

struct KDTree {
  int n = 0, d = 0;
  std::vector<double> pts;   // n*d row-major
  std::vector<int> order;    // permutation; leaves own contiguous ranges
  std::vector<Node> nodes;   // nodes[0] is the root

  const double* pt(int i) const { return pts.data() + (int64_t)order[i] * d; }
};

// minkowski-p distance; p <= 0 means infinity (chebyshev)
inline double dist_p(const double* a, const double* b, int d, double p) {
  if (p <= 0.0) {
    double m = 0.0;
    for (int i = 0; i < d; i++) m = std::max(m, std::fabs(a[i] - b[i]));
    return m;
  }
  if (p == 2.0) {
    double s = 0.0;
    for (int i = 0; i < d; i++) {
      double t = a[i] - b[i];
      s += t * t;
    }
    return std::sqrt(s);
  }
  if (p == 1.0) {
    double s = 0.0;
    for (int i = 0; i < d; i++) s += std::fabs(a[i] - b[i]);
    return s;
  }
  double s = 0.0;
  for (int i = 0; i < d; i++) s += std::pow(std::fabs(a[i] - b[i]), p);
  return std::pow(s, 1.0 / p);
}

// minkowski-p distance from point x to the axis-aligned box [lo, hi]
inline double box_dist(const double* x, const std::vector<double>& lo,
                       const std::vector<double>& hi, int d, double p) {
  if (p <= 0.0) {
    double m = 0.0;
    for (int i = 0; i < d; i++) {
      double t = std::max({lo[i] - x[i], x[i] - hi[i], 0.0});
      m = std::max(m, t);
    }
    return m;
  }
  double s = 0.0;
  for (int i = 0; i < d; i++) {
    double t = std::max({lo[i] - x[i], x[i] - hi[i], 0.0});
    s += (p == 2.0) ? t * t : (p == 1.0 ? t : std::pow(t, p));
  }
  if (p == 2.0) return std::sqrt(s);
  if (p == 1.0) return s;
  return std::pow(s, 1.0 / p);
}

int build_node(KDTree* t, int begin, int end) {
  int id = (int)t->nodes.size();
  t->nodes.emplace_back();
  {
    Node& nd = t->nodes[id];
    nd.begin = begin;
    nd.end = end;
    nd.lo.assign(t->d, std::numeric_limits<double>::infinity());
    nd.hi.assign(t->d, -std::numeric_limits<double>::infinity());
    for (int i = begin; i < end; i++) {
      const double* p = t->pt(i);
      for (int k = 0; k < t->d; k++) {
        nd.lo[k] = std::min(nd.lo[k], p[k]);
        nd.hi[k] = std::max(nd.hi[k], p[k]);
      }
    }
    if (end - begin <= kLeafSize) return id;
    // split the widest axis at the median
    int axis = 0;
    double width = -1.0;
    for (int k = 0; k < t->d; k++) {
      double w = nd.hi[k] - nd.lo[k];
      if (w > width) {
        width = w;
        axis = k;
      }
    }
    if (width <= 0.0) return id;  // all points identical: keep as leaf
    nd.axis = axis;
  }
  int axis = t->nodes[id].axis;
  int mid = (begin + end) / 2;
  std::nth_element(
      t->order.begin() + begin, t->order.begin() + mid, t->order.begin() + end,
      [&](int a, int b) {
        return t->pts[(int64_t)a * t->d + axis] <
               t->pts[(int64_t)b * t->d + axis];
      });
  double split = t->pts[(int64_t)t->order[mid] * t->d + axis];
  // children may reallocate t->nodes; write results back by id afterwards
  int left = build_node(t, begin, mid);
  int right = build_node(t, mid, end);
  Node& nd = t->nodes[id];
  nd.split = split;
  nd.left = left;
  nd.right = right;
  return id;
}

void knn_search(const KDTree* t, int node, const double* x, int k, double p,
                std::priority_queue<std::pair<double, int>>* heap) {
  const Node& nd = t->nodes[node];
  if ((int)heap->size() == k &&
      box_dist(x, nd.lo, nd.hi, t->d, p) > heap->top().first)
    return;
  if (nd.left < 0) {
    for (int i = nd.begin; i < nd.end; i++) {
      double dd = dist_p(x, t->pt(i), t->d, p);
      if ((int)heap->size() < k) {
        heap->push({dd, t->order[i]});
      } else if (dd < heap->top().first ||
                 (dd == heap->top().first && t->order[i] < heap->top().second)) {
        heap->pop();
        heap->push({dd, t->order[i]});
      }
    }
    return;
  }
  int axis = nd.axis;
  int near = (x[axis] <= nd.split) ? nd.left : nd.right;
  int far = (near == nd.left) ? nd.right : nd.left;
  knn_search(t, near, x, k, p, heap);
  knn_search(t, far, x, k, p, heap);
}

void ball_search(const KDTree* t, int node, const double* x, double r,
                 double p, std::vector<int>* out) {
  const Node& nd = t->nodes[node];
  if (box_dist(x, nd.lo, nd.hi, t->d, p) > r) return;
  if (nd.left < 0) {
    for (int i = nd.begin; i < nd.end; i++)
      if (dist_p(x, t->pt(i), t->d, p) <= r) out->push_back(t->order[i]);
    return;
  }
  ball_search(t, nd.left, x, r, p, out);
  ball_search(t, nd.right, x, r, p, out);
}

}  // namespace

extern "C" {

void* kdtree_build(const double* pts, int n, int d) {
  KDTree* t = new KDTree;
  t->n = n;
  t->d = d;
  t->pts.assign(pts, pts + (int64_t)n * d);
  t->order.resize(n);
  for (int i = 0; i < n; i++) t->order[i] = i;
  if (n > 0) build_node(t, 0, n);
  return t;
}

void kdtree_free(void* h) { delete (KDTree*)h; }

// k nearest neighbors of each query (minkowski-p; p<=0 = infinity norm).
// out_dist/out_idx are [nq * k]; missing neighbors (k > n) get inf / -1.
void kdtree_query(void* h, const double* q, int nq, int k, double p,
                  double* out_dist, int32_t* out_idx) {
  const KDTree* t = (const KDTree*)h;
  for (int j = 0; j < nq; j++) {
    std::priority_queue<std::pair<double, int>> heap;
    if (t->n > 0) knn_search(t, 0, q + (int64_t)j * t->d, k, p, &heap);
    int cnt = (int)heap.size();
    for (int i = cnt - 1; i >= 0; i--) {
      out_dist[(int64_t)j * k + i] = heap.top().first;
      out_idx[(int64_t)j * k + i] = heap.top().second;
      heap.pop();
    }
    for (int i = cnt; i < k; i++) {
      out_dist[(int64_t)j * k + i] = std::numeric_limits<double>::infinity();
      out_idx[(int64_t)j * k + i] = -1;
    }
  }
}

// Counts per query of points within radius r; returns the total.
int64_t kdtree_query_ball_count(void* h, const double* q, int nq, double r,
                                double p, int64_t* counts) {
  const KDTree* t = (const KDTree*)h;
  int64_t total = 0;
  std::vector<int> buf;
  for (int j = 0; j < nq; j++) {
    buf.clear();
    if (t->n > 0) ball_search(t, 0, q + (int64_t)j * t->d, r, p, &buf);
    counts[j] = (int64_t)buf.size();
    total += counts[j];
  }
  return total;
}

// Concatenated in-radius indices, query-major (caller sizes the buffer from
// kdtree_query_ball_count). Indices within a query are sorted ascending.
void kdtree_query_ball_fill(void* h, const double* q, int nq, double r,
                            double p, int32_t* out) {
  const KDTree* t = (const KDTree*)h;
  int64_t pos = 0;
  std::vector<int> buf;
  for (int j = 0; j < nq; j++) {
    buf.clear();
    if (t->n > 0) ball_search(t, 0, q + (int64_t)j * t->d, r, p, &buf);
    std::sort(buf.begin(), buf.end());
    for (int idx : buf) out[pos++] = idx;
  }
}

}  // extern "C"
