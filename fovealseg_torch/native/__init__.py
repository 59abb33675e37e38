"""Host C++ and numpy spatial components (counterpart of
``fovealseg_tpu/native/``), built from the sources here at first use:

- ``spatial``: planar Delaunay with barycentric ``find_simplex``, nearest
  neighbour, convex hull, Voronoi, halfspace intersection, procrustes,
  directed Hausdorff;
- ``distance``: ``pdist`` / ``cdist`` / ``squareform``;
- ``kdtree``: ``KDTree`` (``cKDTree``) queries;
- ``rotation``: ``Rotation``, ``Slerp``, ``RotationSpline``;
- ``voronoi``: ``sort_vertices_of_regions``;
- ``interp2d``: the exact 'tri' fill and the ``Interp2D`` call shape.
"""

from fovealseg_torch.native import distance
from fovealseg_torch.native.kdtree import KDTree, cKDTree
from fovealseg_torch.native.rotation import Rotation, RotationSpline, Slerp
from fovealseg_torch.native.spatial import (
    ConvexHull,
    Delaunay,
    HalfspaceIntersection,
    Voronoi,
    directed_hausdorff,
    nearest_neighbor,
    procrustes,
    tsearch,
)
from fovealseg_torch.native.voronoi import sort_vertices_of_regions

__all__ = [
    "ConvexHull",
    "Delaunay",
    "HalfspaceIntersection",
    "Voronoi",
    "directed_hausdorff",
    "nearest_neighbor",
    "procrustes",
    "tsearch",
    "distance",
    "KDTree",
    "cKDTree",
    "Rotation",
    "RotationSpline",
    "Slerp",
    "sort_vertices_of_regions",
]
