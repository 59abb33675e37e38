"""Port: the native spatial components (``fovealseg_torch/native/``) against
the JAX package's ``fovealseg_tpu/native/`` on the same seeded inputs:
``distance`` (every metric of ``pdist`` / ``cdist``, ``squareform``, the
validity checks, the two-vector functions), ``kdtree`` (every query),
``rotation`` (``Rotation``, ``Slerp``, ``RotationSpline``,
``create_group``), ``voronoi`` (``sort_vertices_of_regions``) and the
``spatial`` entry points (``ConvexHull``, ``Voronoi``,
``HalfspaceIntersection``, ``tsearch``, ``procrustes``,
``directed_hausdorff``), plus ``interp2d_dense`` and the gradient of
``interp2d_apply`` against ``jax.grad``.

Tolerances: integer results exact; float64 results within 1e-12 (both
packages build the same C++ with the same flags, and the numpy copies run
the same operations); the float32 interp2d blend within 1e-6. A few scipy
checks stand beside, as the JAX package's own tests have them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import spatial as sci
from scipy.spatial.transform import Rotation as SciRotation

import fovealseg_torch.native as tn
import fovealseg_tpu.native as jn
from fovealseg_torch.native import distance as tdist
from fovealseg_torch.native import interp2d as tinterp
from fovealseg_torch.native.rotation import create_group as t_create_group
from fovealseg_tpu.native import distance as jdist
from fovealseg_tpu.native import interp2d as jinterp
from fovealseg_tpu.native.rotation import create_group as j_create_group

F64 = dict(rtol=1e-12, atol=1e-12)
METRICS = ["euclidean", "sqeuclidean", "cityblock", "chebyshev", "minkowski", "cosine",
           "correlation", "braycurtis", "canberra", "hamming", "jaccard", "seuclidean",
           "mahalanobis"]


def _same(a, b):
    """Equal structures: integer arrays exactly, float arrays within 1e-12."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, **F64)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_pdist_cdist_against_jax(rng, metric):
    x = rng.standard_normal((24, 5))
    y = rng.standard_normal((17, 5))
    if metric in ("hamming", "jaccard"):
        x, y = (x > 0).astype(np.float64), (y > 0).astype(np.float64)
    kw = {"p": 3.5} if metric == "minkowski" else {}
    _same(tdist.pdist(x, metric, **kw), jdist.pdist(x, metric, **kw))
    _same(tdist.cdist(x, y, metric, **kw), jdist.cdist(x, y, metric, **kw))
    fn = metric if metric != "mahalanobis" else None
    if fn is not None and metric != "seuclidean":
        _same(getattr(tdist, fn)(x[0], y[0], **kw), getattr(jdist, fn)(x[0], y[0], **kw))


def test_distance_forms_checks_and_scipy(rng):
    x = rng.standard_normal((9, 3))
    y = tdist.pdist(x)
    m = tdist.squareform(y)
    _same(m, jdist.squareform(jdist.pdist(x)))
    _same(tdist.squareform(m), jdist.squareform(m))
    assert tdist.num_obs_y(y) == jdist.num_obs_y(y) == 9
    assert tdist.num_obs_dm(m) == jdist.num_obs_dm(m) == 9
    assert tdist.is_valid_dm(m) and jdist.is_valid_dm(m)
    assert tdist.is_valid_y(y) and not tdist.is_valid_y(y[:-1]) and not jdist.is_valid_y(y[:-1])
    bad = m.copy()
    bad[0, 1] += 1.0
    assert not tdist.is_valid_dm(bad) and not jdist.is_valid_dm(bad)
    for fn in (tdist, jdist):
        with pytest.raises(ValueError):
            fn.pdist(x, "nope")
        with pytest.raises(ValueError):
            fn.squareform(bad)
    np.testing.assert_allclose(tdist.pdist(x, "cityblock"), sci.distance.pdist(x, "cityblock"),
                               rtol=1e-12)
    np.testing.assert_allclose(tdist.cdist(x, x[:4], "cosine"),
                               sci.distance.cdist(x, x[:4], "cosine"), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("p", [1.0, 2.0, np.inf])
def test_kdtree_queries_against_jax(rng, p):
    a = rng.uniform(0, 4, (70, 3))
    b = rng.uniform(0, 4, (45, 3))
    ta, tb = tn.KDTree(a), tn.KDTree(b)
    ja, jb = jn.KDTree(a), jn.KDTree(b)
    _same(ta.query(b, k=3, p=p), ja.query(b, k=3, p=p))
    _same(ta.query(b[0], k=1, p=p), ja.query(b[0], k=1, p=p))
    _same(ta.query_ball_point(b, 0.9, p=p), ja.query_ball_point(b, 0.9, p=p))
    assert ta.query_pairs(0.7, p=p) == ja.query_pairs(0.7, p=p)
    _same(ta.query_ball_tree(tb, 0.8, p=p), ja.query_ball_tree(jb, 0.8, p=p))
    _same(ta.sparse_distance_matrix(tb, 1.1, p=p, output_type="dict"),
          ja.sparse_distance_matrix(jb, 1.1, p=p, output_type="dict"))
    rs = np.array([0.3, 1.2, 2.5])
    _same(ta.count_neighbors(tb, rs, p=p), ja.count_neighbors(jb, rs, p=p))
    d, i = ta.query(b, k=3, p=p)
    rd, ri = sci.cKDTree(a).query(b, k=3, p=p)
    np.testing.assert_allclose(d, rd, rtol=1e-12)
    np.testing.assert_array_equal(i, ri)
    assert tn.cKDTree is tn.KDTree


def test_spatial_entry_points_against_jax(rng):
    pts = rng.standard_normal((40, 2))
    th, jh = tn.ConvexHull(pts), jn.ConvexHull(pts)
    _same([th.vertices, th.simplices, th.volume, th.area],
          [jh.vertices, jh.simplices, jh.volume, jh.area])
    np.testing.assert_allclose(th.volume, sci.ConvexHull(pts).volume, rtol=1e-12)
    with pytest.raises(ValueError):
        tn.ConvexHull(np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]))

    tv, jv = tn.Voronoi(pts), jn.Voronoi(pts)
    _same([tv.vertices, tv.ridge_points, tv.point_region],
          [jv.vertices, jv.ridge_points, jv.point_region])
    assert tv.regions == jv.regions and tv.ridge_vertices == jv.ridge_vertices

    hs = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [1.0, 1.0, -2.0],
                   [1.0, -0.3, -1.5], [1.0, 0.0, -10.0]])
    ip = np.array([0.5, 0.5])
    _same(tn.HalfspaceIntersection(hs, ip).intersections,
          jn.HalfspaceIntersection(hs, ip).intersections)
    with pytest.raises(ValueError):
        tn.HalfspaceIntersection(hs, np.array([5.0, 5.0]))

    tri_t, tri_j = tn.Delaunay(pts), jn.Delaunay(pts)
    q = rng.standard_normal((64, 2)) * 1.5
    _same(tn.tsearch(tri_t, q), jn.tsearch(tri_j, q))

    d1 = rng.standard_normal((12, 3))
    d2 = 3.0 * d1 @ np.linalg.qr(rng.standard_normal((3, 3)))[0] + 1.5
    _same(tn.procrustes(d1, d2), jn.procrustes(d1, d2))

    a, b = rng.standard_normal((50, 2)), rng.standard_normal((30, 2))
    _same(tn.directed_hausdorff(a, b), jn.directed_hausdorff(a, b))
    np.testing.assert_allclose(tn.directed_hausdorff(a, b), sci.distance.directed_hausdorff(a, b)[0],
                               rtol=1e-12)


def test_rotation_against_jax(rng):
    q = rng.standard_normal((6, 4))
    tr, jr = tn.Rotation.from_quat(q), jn.Rotation.from_quat(q)
    _same([tr.as_quat(), tr.as_matrix(), tr.as_rotvec(), tr.as_euler("zyx"), tr.magnitude()],
          [jr.as_quat(), jr.as_matrix(), jr.as_rotvec(), jr.as_euler("zyx"), jr.magnitude()])
    v = rng.standard_normal((6, 3))
    _same(tr.apply(v), jr.apply(v))
    _same((tr * tr.inv()).as_quat(), (jr * jr.inv()).as_quat())
    _same(tr.mean().as_quat(), jr.mean().as_quat())

    times = np.array([0.0, 1.0, 2.0, 4.0])
    keys = rng.standard_normal((4, 4))
    t = np.array([0.0, 0.3, 1.0, 1.7, 3.9, 4.0])
    _same(tn.Slerp(times, tn.Rotation.from_quat(keys))(t).as_quat(),
          jn.Slerp(times, jn.Rotation.from_quat(keys))(t).as_quat())

    knots = np.array([0.0, 10.0, 20.0, 40.0, 70.0])
    angles = rng.uniform(-60, 60, (5, 3))
    ts = tn.RotationSpline(knots, tn.Rotation.from_euler("XYZ", angles, degrees=True))
    js = jn.RotationSpline(knots, jn.Rotation.from_euler("XYZ", angles, degrees=True))
    s = np.linspace(0.0, 70.0, 29)
    _same([ts(s).as_quat(), ts(s, 1), ts(s, 2)], [js(s).as_quat(), js(s, 1), js(s, 2)])

    for group in ("I", "O", "T", "C5", "D3"):
        _same(t_create_group(tn.Rotation, group).as_quat(),
              j_create_group(jn.Rotation, group).as_quat())
    np.testing.assert_allclose(tr.as_matrix(), SciRotation.from_quat(q).as_matrix(), atol=1e-12)


def test_sort_vertices_of_regions_against_jax(rng):
    pts = rng.normal(size=(30, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    simplices = sci.ConvexHull(pts).simplices
    regions = [[] for _ in range(len(pts))]
    for si, s in enumerate(simplices):
        for v in s:
            regions[v].append(si)
    ours, theirs = [list(r) for r in regions], [list(r) for r in regions]
    tn.sort_vertices_of_regions(simplices, ours)
    jn.sort_vertices_of_regions(simplices, theirs)
    assert ours == theirs


def test_interp2d_dense_and_apply_gradient_against_jax(rng):
    pts = np.concatenate([rng.uniform(0, 15, (30, 2)), [[0, 0], [0, 15], [15, 0], [15, 15]]])
    vals = rng.standard_normal((len(pts), 3)).astype(np.float32)
    _same(tinterp.interp2d_dense(pts, vals, 16, 16), jinterp.interp2d_dense(pts, vals, 16, 16))

    corner, weight = tinterp.build_interp_plan(pts, 16, 16)
    cot = rng.standard_normal((16 * 16, 3)).astype(np.float32)
    v = torch.from_numpy(vals.copy()).requires_grad_(True)
    out = tinterp.interp2d_apply(v, corner, weight)
    (out * torch.from_numpy(cot)).sum().backward()
    ref_out = jinterp.interp2d_apply(jnp.asarray(vals), corner, weight)
    ref_grad = jax.grad(lambda x: (jinterp.interp2d_apply(x, corner, weight) * cot).sum())(
        jnp.asarray(vals))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref_grad), rtol=1e-6, atol=1e-6)
