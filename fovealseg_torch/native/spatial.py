"""Python surface over the port's native library (ctypes): the counterpart
of the JAX package's ``fovealseg_tpu/native/spatial.py``.

* :class:`Delaunay` with ``find_simplex(xi, return_c=True)``, which returns
  barycentric coordinates beside the simplex ids (the reference's one
  functional change to qhull), and its alias :func:`tsearch`;
* :func:`nearest_neighbor`, an exact nearest-point query;
* :class:`ConvexHull`, :class:`Voronoi` (the dual of the Delaunay) and
  :class:`HalfspaceIntersection` for planar input, :func:`procrustes` and
  :func:`directed_hausdorff`.

The library is built at first use with the host's ``g++`` from
``spatial.cpp``, ``distance.cpp`` and ``kdtree.cpp`` into one file,
``build/native/libspatial-<hash>.so`` under the repository root (a directory
git ignores); the hash covers every source and the flags. ``distance.py``
and ``kdtree.py`` load the same library. A failed build raises: no binary
is shipped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "spatial.cpp"
SOURCES = (SOURCE, SOURCE.with_name("distance.cpp"), SOURCE.with_name("kdtree.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libspatial-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native sources unless they are built already; raise on
    failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: fovealseg_torch/native/*.cpp are built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {lib.name} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.delaunay_triangulate.restype = ctypes.c_int
    lib.delaunay_triangulate.argtypes = [dp, ctypes.c_int, ip, ctypes.c_int]
    lib.find_simplex_bary.restype = None
    lib.find_simplex_bary.argtypes = [dp, ctypes.c_int, ip, ctypes.c_int, dp, ctypes.c_int,
                                      ip, dp, ctypes.c_double]
    lib.nearest_neighbor.restype = None
    lib.nearest_neighbor.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int, ip]
    lib.directed_hausdorff.restype = ctypes.c_double
    lib.directed_hausdorff.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int]
    lib.convex_hull.restype = ctypes.c_int
    lib.convex_hull.argtypes = [dp, ctypes.c_int, ip]
    _lib = lib
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class Delaunay:
    """Planar Delaunay triangulation (Bowyer-Watson) with barycentric point
    location; the API shape of ``scipy.spatial.Delaunay``."""

    def __init__(self, points: np.ndarray):
        pts = np.ascontiguousarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"2-D points expected, got shape {pts.shape}")
        self.points = pts
        n = len(pts)
        max_tris = max(4 * n + 16, 64)
        out = np.empty((max_tris, 3), dtype=np.int32)
        cnt = _load().delaunay_triangulate(_dptr(pts), n, _iptr(out), max_tris)
        if cnt < 0:
            raise RuntimeError("triangle buffer overflow")
        self.simplices = np.ascontiguousarray(out[:cnt])

    def find_simplex(self, xi: np.ndarray, return_c: bool = False, tol: float = 1e-9):
        """Simplex id of each query point (-1 outside the hull) and, with
        ``return_c``, its barycentric coordinates [q, 3]."""
        q = np.ascontiguousarray(xi, dtype=np.float64).reshape(-1, 2)
        simplex = np.empty(len(q), dtype=np.int32)
        bary = np.zeros((len(q), 3), dtype=np.float64)
        _load().find_simplex_bary(
            _dptr(self.points), len(self.points),
            _iptr(self.simplices), len(self.simplices),
            _dptr(q), len(q), _iptr(simplex), _dptr(bary), tol,
        )
        if return_c:
            return simplex, bary
        return simplex


def nearest_neighbor(points: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of the nearest point for each query (exact, grid-bucketed)."""
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    q = np.ascontiguousarray(queries, dtype=np.float64).reshape(-1, 2)
    out = np.empty(len(q), dtype=np.int32)
    _load().nearest_neighbor(_dptr(pts), len(pts), _dptr(q), len(q), _iptr(out))
    return out


def tsearch(tri: Delaunay, xi: np.ndarray) -> np.ndarray:
    """Matlab-style alias: simplex index containing each query point
    (spatial/qhull.pyx ``tsearch`` = ``Delaunay.find_simplex``)."""
    return tri.find_simplex(xi)


class ConvexHull:
    """Planar convex hull (native monotone chain).

    Mirrors the 2-D slice of ``spatial.qhull.ConvexHull``: ``vertices`` are
    the extreme-point indices in counterclockwise order, ``simplices`` the
    hull facets (edges) as index pairs, ``volume`` the enclosed area and
    ``area`` the perimeter (qhull's 2-D convention).
    """

    def __init__(self, points: np.ndarray):
        pts = np.ascontiguousarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"2-D points expected, got shape {pts.shape}")
        if len(pts) < 3:
            raise ValueError("ConvexHull needs at least 3 points")
        self.points = pts
        out = np.empty(len(pts), dtype=np.int32)
        m = _load().convex_hull(_dptr(pts), len(pts), _iptr(out))
        if m < 3:
            raise ValueError("points are collinear: hull is degenerate")
        self.vertices = np.ascontiguousarray(out[:m])
        nxt = np.roll(self.vertices, -1)
        self.simplices = np.stack([self.vertices, nxt], axis=1).astype(np.int32)
        p = pts[self.vertices]
        q = pts[nxt]
        self.volume = float(0.5 * np.sum(p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]))
        self.area = float(np.sum(np.hypot(*(q - p).T)))


def _circumcenters(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Circumcenter of each triangle (row of vertex indices)."""
    a, b, c = (points[tris[:, k]] for k in range(3))
    ab, ac = b - a, c - a
    d = 2.0 * (ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0])
    d = np.where(d == 0.0, np.finfo(np.float64).tiny, d)
    ab2 = np.sum(ab * ab, axis=1)
    ac2 = np.sum(ac * ac, axis=1)
    ux = (ac[:, 1] * ab2 - ab[:, 1] * ac2) / d
    uy = (ab[:, 0] * ac2 - ac[:, 0] * ab2) / d
    return a + np.stack([ux, uy], axis=1)


class Voronoi:
    """Planar Voronoi diagram as the dual of the native Delaunay.

    Mirrors the field surface of ``spatial.qhull.Voronoi`` for 2-D input:
    ``vertices`` (circumcenters of the Delaunay triangles), ``ridge_points``
    (the Delaunay edge dual to each ridge), ``ridge_vertices`` (pairs of
    Voronoi vertex indices, -1 for the unbounded side of a hull edge),
    ``regions`` + ``point_region`` (per-input-point vertex cycles, with -1
    marking the open boundary of unbounded cells).  Index *order* is
    implementation-defined (as it is for qhull); tests compare structurally.
    """

    def __init__(self, points: np.ndarray):
        pts = np.ascontiguousarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"2-D points expected, got shape {pts.shape}")
        self.points = pts
        tri = Delaunay(pts)
        tris = tri.simplices
        self.vertices = _circumcenters(pts, tris)

        # Delaunay edge -> adjacent triangle ids (1 = hull edge, 2 = interior)
        edge_tris: dict[tuple[int, int], list[int]] = {}
        for t, (a, b, c) in enumerate(tris):
            for u, v in ((a, b), (b, c), (c, a)):
                edge_tris.setdefault((min(u, v), max(u, v)), []).append(t)

        ridge_points, ridge_vertices = [], []
        point_edges: dict[int, list[int]] = {}
        for ridx, ((u, v), ts) in enumerate(edge_tris.items()):
            ridge_points.append((u, v))
            ridge_vertices.append(list(ts) if len(ts) == 2 else [-1, ts[0]])
            point_edges.setdefault(u, []).append(ridx)
            point_edges.setdefault(v, []).append(ridx)
        self.ridge_points = np.asarray(ridge_points, dtype=np.int32).reshape(-1, 2)
        self.ridge_vertices = ridge_vertices

        # Regions: the Voronoi cell of input point i is the cycle of
        # circumcenters of the triangles incident to i, ordered by angle
        # around i; unbounded cells (hull points) get a single -1 inserted.
        tri_of_point: dict[int, list[int]] = {}
        for t, verts in enumerate(tris):
            for p in verts:
                tri_of_point.setdefault(int(p), []).append(t)
        self.regions: list[list[int]] = [[]]  # qhull always emits one empty region
        self.point_region = np.zeros(len(pts), dtype=np.intp)
        for i in range(len(pts)):
            ts = tri_of_point.get(i, [])
            if not ts:
                self.point_region[i] = 0
                continue
            centers = self.vertices[ts]
            ang = np.arctan2(centers[:, 1] - pts[i, 1], centers[:, 0] - pts[i, 0])
            cyc = [ts[k] for k in np.argsort(ang)]
            unbounded = any(
                len(edge_tris[e]) == 1
                for e in (tuple(sorted((int(u), int(v))))
                          for t in ts
                          for (u, v) in _edges_of(tris[t]) if i in (u, v))
            )
            if unbounded:
                cyc.append(-1)
            self.point_region[i] = len(self.regions)
            self.regions.append(cyc)


def _edges_of(tri_row) -> list[tuple[int, int]]:
    a, b, c = (int(x) for x in tri_row)
    return [(a, b), (b, c), (c, a)]


class HalfspaceIntersection:
    """2-D halfspace intersection via point-hull duality
    (``spatial.qhull.HalfspaceIntersection`` surface for the planar case).

    ``halfspaces`` is [m, 3] rows (A | b) meaning A @ x + b <= 0;
    ``interior_point`` must strictly satisfy every inequality.
    ``intersections`` holds the polygon vertices (one per adjacent
    facet pair of the dual hull).
    """

    def __init__(self, halfspaces: np.ndarray, interior_point: np.ndarray):
        hs = np.ascontiguousarray(halfspaces, dtype=np.float64)
        ip = np.asarray(interior_point, dtype=np.float64).reshape(2)
        if hs.ndim != 2 or hs.shape[1] != 3:
            raise ValueError(f"[m, 3] (A|b) rows expected, got shape {hs.shape}")
        self.halfspaces = hs
        self.interior_point = ip
        a, b = hs[:, :2], hs[:, 2]
        slack = -(b + a @ ip)
        if np.any(slack <= 0):
            raise ValueError("interior_point is not strictly interior")
        dual = a / slack[:, None]
        hull = ConvexHull(dual)
        pts = []
        self.dual_facets = hull.simplices.copy()
        for e1, e2 in hull.simplices:
            a1, b1 = a[e1], b[e1] + a[e1] @ ip
            a2, b2 = a[e2], b[e2] + a[e2] @ ip
            m = np.stack([a1, a2])
            x = np.linalg.solve(m, -np.asarray([b1, b2]))
            pts.append(x + ip)
        self.intersections = np.asarray(pts).reshape(-1, 2)


def procrustes(data1: np.ndarray, data2: np.ndarray):
    """Orthogonal Procrustes analysis (``spatial._procrustes.procrustes``
    work-alike): returns the standardized reference ``mtx1``, the optimally
    transformed ``mtx2`` and the residual ``disparity``."""
    mtx1 = np.array(data1, dtype=np.float64, copy=True)
    mtx2 = np.array(data2, dtype=np.float64, copy=True)
    if mtx1.ndim != 2 or mtx2.ndim != 2 or mtx1.shape != mtx2.shape:
        raise ValueError("input matrices must be two-dimensional and equal-shape")
    if mtx1.size == 0:
        raise ValueError("input matrices must contain data")
    mtx1 -= mtx1.mean(0)
    mtx2 -= mtx2.mean(0)
    n1, n2 = np.linalg.norm(mtx1), np.linalg.norm(mtx2)
    if n1 == 0 or n2 == 0:
        raise ValueError("input matrices must contain more than one unique point")
    mtx1 /= n1
    mtx2 /= n2
    u, w, vt = np.linalg.svd(mtx2.T @ mtx1)
    r = u @ vt
    s = w.sum()
    mtx2 = s * (mtx2 @ r)
    disparity = float(np.sum((mtx1 - mtx2) ** 2))
    return mtx1, mtx2, disparity


def directed_hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    """The directed Hausdorff distance from the planar set ``a`` to ``b``."""
    aa = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 2)
    bb = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 2)
    return float(_load().directed_hausdorff(_dptr(aa), len(aa), _dptr(bb), len(bb)))
