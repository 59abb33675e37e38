"""``scipy.spatial.distance``'s surface over the native metric kernels
(counterpart of ``fovealseg_tpu/native/distance.py``): ``pdist``, ``cdist``,
``squareform``, the validity checks and the two-vector metric functions. The
loops are in ``distance.cpp``, part of the port's native library
(``native/spatial.py::build``); this module checks the inputs, defaults the
auxiliary parameters (V for seuclidean, VI for mahalanobis) as scipy does,
and converts between condensed and square forms.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fovealseg_torch.native.spatial import _load as _load_base

_METRIC_IDS = {
    "euclidean": 0,
    "sqeuclidean": 1,
    "cityblock": 2,
    "chebyshev": 3,
    "minkowski": 4,
    "cosine": 5,
    "correlation": 6,
    "braycurtis": 7,
    "canberra": 8,
    "hamming": 9,
    "jaccard": 10,
    "seuclidean": 11,
    "mahalanobis": 12,
}
# common aliases accepted by scipy
_ALIASES = {
    "euclid": "euclidean",
    "l2": "euclidean",
    "sqe": "sqeuclidean",
    "manhattan": "cityblock",
    "l1": "cityblock",
    "taxicab": "cityblock",
    "cheby": "chebyshev",
    "chebychev": "chebyshev",
    "infinity": "chebyshev",
    "mi": "minkowski",
    "cos": "cosine",
    "co": "correlation",
    "bray": "braycurtis",
    "ham": "hamming",
    "jac": "jaccard",
    "se": "seuclidean",
    "mahal": "mahalanobis",
}

_decl_done = False


def _lib():
    global _decl_done
    lib = _load_base()
    if not _decl_done:
        dp = ctypes.POINTER(ctypes.c_double)
        lib.pdist_native.restype = None
        lib.pdist_native.argtypes = [
            dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            dp, dp,
        ]
        lib.cdist_native.restype = None
        lib.cdist_native.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, dp, dp,
        ]
        _decl_done = True
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _resolve(metric: str) -> int:
    m = metric.lower()
    m = _ALIASES.get(m, m)
    if m not in _METRIC_IDS:
        raise ValueError(f"unknown distance metric: {metric!r}")
    return _METRIC_IDS[m]


def _aux_for(mid: int, X: np.ndarray, XB, V, VI) -> np.ndarray | None:
    """Default V (seuclidean) / VI (mahalanobis) the way scipy does."""
    d = X.shape[1]
    if mid == 11:
        if V is None:
            stacked = X if XB is None else np.vstack([X, XB])
            V = np.var(stacked.astype(np.float64), axis=0, ddof=1)
        V = np.ascontiguousarray(V, dtype=np.float64)
        if V.shape != (d,):
            raise ValueError("V must have one entry per dimension")
        return V
    if mid == 12:
        if VI is None:
            stacked = X if XB is None else np.vstack([X, XB])
            if len(stacked) <= d:
                raise ValueError(
                    "number of observations must exceed dimension for "
                    "mahalanobis covariance estimation")
            VI = np.linalg.inv(np.cov(stacked.astype(np.float64).T)).T
        VI = np.ascontiguousarray(VI, dtype=np.float64)
        if VI.shape != (d, d):
            raise ValueError("VI must be [d, d]")
        return VI
    return None


def pdist(X, metric: str = "euclidean", *, p: float = 2.0, V=None, VI=None):
    """Condensed pairwise distances (scipy.spatial.distance.pdist surface)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError("X must be 2-D")
    n, d = X.shape
    mid = _resolve(metric)
    aux = _aux_for(mid, X, None, V, VI)
    out = np.empty(n * (n - 1) // 2, dtype=np.float64)
    _lib().pdist_native(_dp(X), n, d, mid, float(p),
                        _dp(aux) if aux is not None else None, _dp(out))
    return out


def cdist(XA, XB, metric: str = "euclidean", *, p: float = 2.0, V=None,
          VI=None):
    """Cross distance matrix [na, nb] (scipy.spatial.distance.cdist surface)."""
    XA = np.ascontiguousarray(XA, dtype=np.float64)
    XB = np.ascontiguousarray(XB, dtype=np.float64)
    if XA.ndim != 2 or XB.ndim != 2 or XA.shape[1] != XB.shape[1]:
        raise ValueError("XA, XB must be 2-D with matching column count")
    na, d = XA.shape
    nb = XB.shape[0]
    mid = _resolve(metric)
    aux = _aux_for(mid, XA, XB, V, VI)
    out = np.empty((na, nb), dtype=np.float64)
    _lib().cdist_native(_dp(XA), na, _dp(XB), nb, d, mid, float(p),
                        _dp(aux) if aux is not None else None, _dp(out))
    return out


def squareform(X, force: str = "no", checks: bool = True):
    """Convert condensed <-> square distance representations."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    to_matrix = X.ndim == 1 if force == "no" else force == "tomatrix"
    if to_matrix:
        if X.ndim != 1:
            raise ValueError("tomatrix requires a condensed 1-D vector")
        m = X.shape[0]
        n = int(round((1.0 + np.sqrt(1.0 + 8.0 * m)) / 2.0))
        if n * (n - 1) // 2 != m:
            raise ValueError("incompatible condensed vector length")
        out = np.zeros((n, n), dtype=np.float64)
        iu = np.triu_indices(n, k=1)
        out[iu] = X
        out[(iu[1], iu[0])] = X
        return out
    if X.ndim != 2 or X.shape[0] != X.shape[1]:
        raise ValueError("tovector requires a square matrix")
    if checks:
        if not np.allclose(X, X.T):
            raise ValueError("distance matrix must be symmetric")
        if not np.allclose(np.diag(X), 0.0):
            raise ValueError("distance matrix diagonal must be zero")
    return X[np.triu_indices(X.shape[0], k=1)].copy()


def num_obs_y(Y) -> int:
    """Number of observations in a condensed distance vector."""
    m = np.asarray(Y).shape[0]
    n = int(round((1.0 + np.sqrt(1.0 + 8.0 * m)) / 2.0))
    if n * (n - 1) // 2 != m:
        raise ValueError("improper condensed length")
    return n


def num_obs_dm(D) -> int:
    D = np.asarray(D)
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        raise ValueError("distance matrix must be square")
    return D.shape[0]


def is_valid_dm(D, tol: float = 0.0) -> bool:
    D = np.asarray(D, dtype=np.float64)
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        return False
    if not np.all(np.abs(D - D.T) <= tol):
        return False
    return bool(np.all(np.abs(np.diag(D)) <= tol))


def is_valid_y(Y) -> bool:
    Y = np.asarray(Y)
    if Y.ndim != 1:
        return False
    m = Y.shape[0]
    n = int(round((1.0 + np.sqrt(1.0 + 8.0 * m)) / 2.0))
    return n * (n - 1) // 2 == m


def _pairwise(metric):
    def fn(u, v, **kw):
        u = np.ascontiguousarray(u, dtype=np.float64).reshape(1, -1)
        v = np.ascontiguousarray(v, dtype=np.float64).reshape(1, -1)
        return float(cdist(u, v, metric, **kw)[0, 0])
    fn.__name__ = metric
    fn.__doc__ = f"{metric} distance between two 1-D vectors."
    return fn


euclidean = _pairwise("euclidean")
sqeuclidean = _pairwise("sqeuclidean")
cityblock = _pairwise("cityblock")
chebyshev = _pairwise("chebyshev")
minkowski = _pairwise("minkowski")
cosine = _pairwise("cosine")
correlation = _pairwise("correlation")
braycurtis = _pairwise("braycurtis")
canberra = _pairwise("canberra")
hamming = _pairwise("hamming")
jaccard = _pairwise("jaccard")
seuclidean = _pairwise("seuclidean")
mahalanobis = _pairwise("mahalanobis")
