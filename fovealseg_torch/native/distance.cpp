// Pairwise-distance kernels (pdist / cdist) over the metric set of
// scipy.spatial.distance: the port's copy of fovealseg_tpu/native/distance.cpp,
// unchanged below this note. Built into the port's one native library by
// fovealseg_torch/native/spatial.py and called through ctypes from
// native/distance.py, which holds the validation and the condensed/square
// conversions.
//
// Metric ids (keep in sync with native/distance.py):
//   0 euclidean  1 sqeuclidean  2 cityblock  3 chebyshev  4 minkowski(p)
//   5 cosine     6 correlation  7 braycurtis 8 canberra   9 hamming
//  10 jaccard   11 seuclidean(aux=V[d])      12 mahalanobis(aux=VI[d*d])

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

double metric_one(const double* u, const double* v, int d, int metric,
                  double p, const double* aux) {
  switch (metric) {
    case 0: {  // euclidean
      double s = 0.0;
      for (int i = 0; i < d; i++) {
        double t = u[i] - v[i];
        s += t * t;
      }
      return std::sqrt(s);
    }
    case 1: {  // sqeuclidean
      double s = 0.0;
      for (int i = 0; i < d; i++) {
        double t = u[i] - v[i];
        s += t * t;
      }
      return s;
    }
    case 2: {  // cityblock
      double s = 0.0;
      for (int i = 0; i < d; i++) s += std::fabs(u[i] - v[i]);
      return s;
    }
    case 3: {  // chebyshev
      double s = 0.0;
      for (int i = 0; i < d; i++) s = std::max(s, std::fabs(u[i] - v[i]));
      return s;
    }
    case 4: {  // minkowski
      double s = 0.0;
      for (int i = 0; i < d; i++) s += std::pow(std::fabs(u[i] - v[i]), p);
      return std::pow(s, 1.0 / p);
    }
    case 5: {  // cosine
      double uv = 0.0, uu = 0.0, vv = 0.0;
      for (int i = 0; i < d; i++) {
        uv += u[i] * v[i];
        uu += u[i] * u[i];
        vv += v[i] * v[i];
      }
      return 1.0 - uv / std::sqrt(uu * vv);
    }
    case 6: {  // correlation: cosine of mean-centred vectors
      double mu = 0.0, mv = 0.0;
      for (int i = 0; i < d; i++) {
        mu += u[i];
        mv += v[i];
      }
      mu /= d;
      mv /= d;
      double uv = 0.0, uu = 0.0, vv = 0.0;
      for (int i = 0; i < d; i++) {
        double a = u[i] - mu, b = v[i] - mv;
        uv += a * b;
        uu += a * a;
        vv += b * b;
      }
      return 1.0 - uv / std::sqrt(uu * vv);
    }
    case 7: {  // braycurtis
      double num = 0.0, den = 0.0;
      for (int i = 0; i < d; i++) {
        num += std::fabs(u[i] - v[i]);
        den += std::fabs(u[i] + v[i]);
      }
      return num / den;
    }
    case 8: {  // canberra (0/0 terms contribute 0, scipy convention)
      double s = 0.0;
      for (int i = 0; i < d; i++) {
        double den = std::fabs(u[i]) + std::fabs(v[i]);
        if (den > 0.0) s += std::fabs(u[i] - v[i]) / den;
      }
      return s;
    }
    case 9: {  // hamming (fraction of disagreeing components)
      int c = 0;
      for (int i = 0; i < d; i++) c += (u[i] != v[i]);
      return (double)c / d;
    }
    case 10: {  // jaccard over nonzero patterns (scipy booleanizes first:
                // disagreement means the BOOLEAN patterns differ, so two
                // different nonzero values do NOT count)
      int neq = 0, nnz = 0;
      for (int i = 0; i < d; i++) {
        bool a = u[i] != 0.0, b = v[i] != 0.0;
        if (a || b) {
          nnz++;
          if (a != b) neq++;
        }
      }
      return nnz == 0 ? 0.0 : (double)neq / nnz;
    }
    case 11: {  // seuclidean, aux = component variances V[d]
      double s = 0.0;
      for (int i = 0; i < d; i++) {
        double t = u[i] - v[i];
        s += t * t / aux[i];
      }
      return std::sqrt(s);
    }
    case 12: {  // mahalanobis, aux = inverse covariance VI[d*d] row-major
      std::vector<double> diff(d);
      for (int i = 0; i < d; i++) diff[i] = u[i] - v[i];
      double s = 0.0;
      for (int i = 0; i < d; i++) {
        double acc = 0.0;
        for (int j = 0; j < d; j++) acc += aux[i * d + j] * diff[j];
        s += acc * diff[i];
      }
      return std::sqrt(s);
    }
    default:
      return std::nan("");
  }
}

}  // namespace

extern "C" {

// Condensed pairwise distances of X [n x d] -> out [n*(n-1)/2].
void pdist_native(const double* X, int n, int d, int metric, double p,
                  const double* aux, double* out) {
  int64_t k = 0;
  for (int i = 0; i < n; i++)
    for (int j = i + 1; j < n; j++)
      out[k++] = metric_one(X + (int64_t)i * d, X + (int64_t)j * d, d, metric,
                            p, aux);
}

// Cross distances XA [na x d] vs XB [nb x d] -> out [na x nb] row-major.
void cdist_native(const double* XA, int na, const double* XB, int nb, int d,
                  int metric, double p, const double* aux, double* out) {
  for (int i = 0; i < na; i++)
    for (int j = 0; j < nb; j++)
      out[(int64_t)i * nb + j] = metric_one(
          XA + (int64_t)i * d, XB + (int64_t)j * d, d, metric, p, aux);
}

}  // extern "C"
