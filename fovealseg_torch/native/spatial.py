"""Python surface over ``spatial.cpp`` (ctypes): the part of the JAX
package's ``fovealseg_tpu/native/spatial.py`` that the exact 'tri' fill uses.

* :class:`Delaunay` with ``find_simplex(xi, return_c=True)``, which returns
  barycentric coordinates beside the simplex ids (the reference's one
  functional change to qhull);
* :func:`nearest_neighbor`, an exact nearest-point query.

The library is built at first use with the host's ``g++`` into
``build/native/libspatial-<hash>.so`` under the repository root (a directory
git ignores); the hash covers the source and the flags. A failed build
raises: no binary is shipped.
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
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libspatial-{digest}.so"


def build() -> Path:
    """Compile ``spatial.cpp`` unless it is built already; raise on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: fovealseg_torch/native/spatial.cpp is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
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
