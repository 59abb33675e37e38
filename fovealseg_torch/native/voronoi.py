"""Spherical-Voronoi region vertex sorting (counterpart of
``fovealseg_tpu/native/voronoi.py``, a numpy copy; scipy's
``spatial._voronoi.sort_vertices_of_regions``).

Given the Delaunay ``simplices`` of points on a sphere and the Voronoi
``regions`` (for each generator, the list of incident-simplex ids = the ids
of its Voronoi-cell circumcenter vertices), reorder each region so that its
vertices form a counter-directed walk around the cell boundary: consecutive
entries are circumcenters of triangles sharing an edge.
"""

from __future__ import annotations

import numpy as np


def sort_vertices_of_regions(simplices: np.ndarray, regions: list) -> None:
    """Sort each region's vertex (simplex) ids into boundary-walk order.

    Mutates ``regions`` in place, mirroring the reference signature
    (_voronoi.pyx ``sort_vertices_of_regions(simplices, regions)``).
    """
    simplices = np.asarray(simplices)
    vert_sets = [set(s) for s in simplices]
    for ri, region in enumerate(regions):
        n = len(region)
        if n <= 2:
            continue
        remaining = list(region[1:])
        ordered = [region[0]]
        while remaining:
            cur = vert_sets[ordered[-1]]
            nxt = None
            for t in remaining:
                # adjacent triangles around the generator share an edge
                # (two common vertices, one of which is the generator)
                if len(cur & vert_sets[t]) == 2:
                    nxt = t
                    break
            if nxt is None:
                # disconnected fan (degenerate input): keep original order
                ordered.extend(remaining)
                break
            ordered.append(nxt)
            remaining.remove(nxt)
        regions[ri] = ordered
