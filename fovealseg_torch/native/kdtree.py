"""A ``cKDTree`` work-alike over the native k-d tree (counterpart of
``fovealseg_tpu/native/kdtree.py``; the tree is ``kdtree.cpp``, part of the
port's native library). ``KDTree(data)`` with ``query``,
``query_ball_point``, ``query_pairs``, ``query_ball_tree``,
``sparse_distance_matrix`` and ``count_neighbors``, over the minkowski-p
metrics (``p=inf`` too).
"""

from __future__ import annotations

import ctypes

import numpy as np

from fovealseg_torch.native.spatial import _load as _load_base

_decl_done = False


def _lib():
    global _decl_done
    lib = _load_base()
    if not _decl_done:
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [dp, ctypes.c_int, ctypes.c_int]
        lib.kdtree_free.restype = None
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_query.restype = None
        lib.kdtree_query.argtypes = [
            ctypes.c_void_p, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            dp, ip,
        ]
        lib.kdtree_query_ball_count.restype = ctypes.c_int64
        lib.kdtree_query_ball_count.argtypes = [
            ctypes.c_void_p, dp, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, lp,
        ]
        lib.kdtree_query_ball_fill.restype = None
        lib.kdtree_query_ball_fill.argtypes = [
            ctypes.c_void_p, dp, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ip,
        ]
        _decl_done = True
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _norm_p(p) -> float:
    """Map scipy's p (>=1, inf allowed) to the kernel encoding (p<=0 = inf)."""
    p = float(p)
    if np.isinf(p):
        return 0.0
    if p < 1.0:
        raise ValueError("p must be at least 1")
    return p


class KDTree:
    """k-d tree over an [n, d] point set (scipy cKDTree surface slice)."""

    def __init__(self, data):
        self.data = np.ascontiguousarray(data, dtype=np.float64)
        if self.data.ndim != 2:
            raise ValueError("data must be [n, d]")
        self.n, self.m = self.data.shape
        self._h = _lib().kdtree_build(_dp(self.data), self.n, self.m)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                _lib().kdtree_free(h)
            except Exception:
                pass
            self._h = None

    def _queries(self, x) -> tuple[np.ndarray, bool]:
        q = np.ascontiguousarray(x, dtype=np.float64)
        single = q.ndim == 1
        q = q.reshape(-1, self.m)
        return q, single

    def query(self, x, k: int = 1, p: float = 2.0):
        """(distances, indices) of the k nearest neighbors of each query.

        Matches scipy shape semantics: k=1 squeezes the neighbor axis; a
        single 1-D query point returns scalars/1-D.
        """
        q, single = self._queries(x)
        nq = len(q)
        dist = np.empty((nq, k), dtype=np.float64)
        idx = np.full((nq, k), -1, dtype=np.int32)
        _lib().kdtree_query(self._h, _dp(q), nq, int(k), _norm_p(p),
                            _dp(dist), idx.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int32)))
        idx = idx.astype(np.int64)
        idx[idx < 0] = self.n  # scipy's missing-neighbor sentinel
        if k == 1:
            dist, idx = dist[:, 0], idx[:, 0]
        if single:
            dist, idx = dist[0], idx[0]
        return dist, idx

    def query_ball_point(self, x, r: float, p: float = 2.0):
        """Indices within radius r of each query (sorted per query)."""
        q, single = self._queries(x)
        nq = len(q)
        counts = np.empty(nq, dtype=np.int64)
        total = _lib().kdtree_query_ball_count(
            self._h, _dp(q), nq, float(r), _norm_p(p),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        flat = np.empty(int(total), dtype=np.int32)
        _lib().kdtree_query_ball_fill(
            self._h, _dp(q), nq, float(r), _norm_p(p),
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        splits = np.cumsum(counts)[:-1]
        lists = [a.tolist() for a in np.split(flat, splits)]
        return lists[0] if single else lists

    def query_pairs(self, r: float, p: float = 2.0):
        """Set of index pairs (i < j) within distance r of each other."""
        balls = self.query_ball_point(self.data, r, p=p)
        out = set()
        for i, neigh in enumerate(balls):
            for j in neigh:
                if j > i:
                    out.add((i, j))
        return out

    def query_ball_tree(self, other: "KDTree", r: float, p: float = 2.0):
        """For each point in self, the indices of points in ``other`` within
        distance r — scipy's ``cKDTree.query_ball_tree`` surface. The
        traversal runs in the native tree of ``other``; scipy's dual-tree
        walk is an optimization with identical results."""
        return other.query_ball_point(self.data, r, p=p)

    def sparse_distance_matrix(self, other: "KDTree", max_distance: float,
                               p: float = 2.0, output_type: str = "dok_matrix"):
        """Sparse matrix of distances between all pairs (i in self, j in
        other) with distance <= max_distance — scipy's
        ``cKDTree.sparse_distance_matrix`` surface.

        ``output_type``: 'dok_matrix' (default), 'coo_matrix' or 'dict'
        ({(i, j): distance}).
        """
        pairs: dict[tuple[int, int], float] = {}
        pf = float(p)
        for i, neigh in enumerate(self.query_ball_tree(other, max_distance, p=p)):
            if not neigh:
                continue
            diff = np.abs(other.data[neigh] - self.data[i])
            if np.isinf(pf):
                d = diff.max(axis=1)
            elif pf == 2.0:
                d = np.sqrt((diff * diff).sum(axis=1))
            elif pf == 1.0:
                d = diff.sum(axis=1)
            else:
                d = (diff**pf).sum(axis=1) ** (1.0 / pf)
            for j, dj in zip(neigh, d):
                pairs[(i, int(j))] = float(dj)
        if output_type == "dict":
            return pairs
        from scipy import sparse

        if output_type == "dok_matrix":
            m = sparse.dok_matrix((self.n, other.n))
            for k, v in pairs.items():
                m[k] = v
            return m
        if output_type == "coo_matrix":
            if pairs:
                ij = np.array(list(pairs), dtype=np.int64)
                v = np.fromiter(pairs.values(), dtype=np.float64, count=len(pairs))
                return sparse.coo_matrix((v, (ij[:, 0], ij[:, 1])),
                                         shape=(self.n, other.n))
            return sparse.coo_matrix((self.n, other.n))
        raise ValueError(f"unknown output_type {output_type!r}")

    def count_neighbors(self, other: "KDTree", r, p: float = 2.0):
        """Number of pairs (x1 in self, x2 in other) with dist <= r.

        r may be a scalar or an array (one count per radius).
        """
        rs = np.atleast_1d(np.asarray(r, dtype=np.float64))
        nq = self.n
        counts = np.empty(nq, dtype=np.int64)
        out = np.empty(len(rs), dtype=np.int64)
        for i, rr in enumerate(rs):
            out[i] = _lib().kdtree_query_ball_count(
                other._h, _dp(self.data), nq, float(rr), _norm_p(p),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return int(out[0]) if np.isscalar(r) or np.asarray(r).ndim == 0 else out


cKDTree = KDTree
