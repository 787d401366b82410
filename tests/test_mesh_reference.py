"""mesh_intersect against a numpy all-pairs Moller-Trumbore reference.

The meshes are an icosahedron, smoothed and closed icospheres of several
subdivisions and a torus knot; each is run through both the dense
all-pairs route (``mesh_forest_intersect`` on the one mesh) and the
threaded-BVH walk (``mesh_intersect``) and compared with the reference. The
reference is float64, tests every (ray, triangle) pair and keeps the
nearest; it has no acceleration structure to share bugs with.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.bigmesh import icosphere
from demos.mesh_render import torus_knot
from source_tpu.primitive.mesh.data import MeshData
from source_tpu.tracer import meshtrace
from source_tpu.tracer.meshtrace import mesh_forest_intersect, mesh_intersect


def all_pairs_reference(verts, tris, o, d, t_min):
    """Nearest hit per ray, float64: (t, triangle, u, v, front)."""
    v = np.asarray(verts, np.float64)
    a, b, c = (v[np.asarray(tris)[:, k]] for k in range(3))
    o = np.asarray(o, np.float64)[:, None, :]
    d = np.asarray(d, np.float64)[:, None, :]
    e1, e2 = b - a, c - a
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        tv = o - a[None]
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1[None])
        w = (d * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
    ok = (det != 0) & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > np.asarray(t_min)[:, None])
    t = np.where(ok, t, np.inf)
    k = t.argmin(1)
    rows = np.arange(len(k))
    hit = np.isfinite(t[rows, k])
    return (np.where(hit, t[rows, k], np.inf), np.where(hit, k, -1),
            u[rows, k], w[rows, k], det[rows, k] > 0)


def _icosahedron():
    return icosphere(0)


MESHES = {
    "icosahedron": lambda: (_icosahedron(), False),
    "icosphere2_smooth": lambda: (icosphere(2), True),
    "icosphere3_closed": lambda: (icosphere(3), True),
    "torus_knot": lambda: (torus_knot(segments=64, sides=8), True),
}


def _tables(name):
    (v, f), smoothing = MESHES[name]()
    data = MeshData(v, f, smoothing=smoothing, closed=True)
    return data.to_tables(np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))


def _route(route, mesh, o, d, t_min):
    if route == "dense":  # identity transform: world space is local space
        return mesh_forest_intersect([mesh], o, d, t_min)[0]
    return mesh_intersect(mesh, o, d, t_min)


def _rays(kind, n=512, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "aimed":  # from outside toward the mesh, some missing
        o = rng.uniform(-3, 3, (n, 3))
        d = rng.uniform(-0.8, 0.8, (n, 3)) - o
        d[::7] = rng.normal(size=d[::7].shape)
    else:  # from inside and around the mesh in every direction
        o = rng.uniform(-1.2, 1.2, (n, 3))
        d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("route", ["dense", "bvh"])
@pytest.mark.parametrize("kind", ["aimed", "inside"])
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_intersect_matches_all_pairs(name, kind, route):
    mesh = _tables(name)
    o, d = _rays(kind)
    t_min = np.full(len(o), 1e-4, np.float32)
    got = jax.device_get(_route(route, mesh, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_min)))
    t, tri, u, v, front = all_pairs_reference(mesh.vertices, mesh.triangles,
                                              o, d, t_min)
    hit = tri >= 0
    # f32 against f64 may only disagree on a ray through a shared edge or
    # vertex (then both triangles are hit at the same t)
    same_hit = (got["tri"] >= 0) == hit
    assert same_hit.mean() >= 0.998
    m = same_hit & hit
    assert m.sum() > 0.2 * len(o)
    np.testing.assert_allclose(got["t"][m], t[m], rtol=2e-5, atol=2e-5)
    same = got["tri"][m] == tri[m]
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(got["front"][m][same], front[m][same])
    np.testing.assert_allclose(got["u"][m][same], u[m][same], atol=1e-4)
    np.testing.assert_allclose(got["v"][m][same], v[m][same], atol=1e-4)


def test_mirrored_instances_through_the_dense_forest():
    """Two instances of one mesh (one mirrored) share a dense call in
    intersect_scene; each hit matches the reference on its own instance."""
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.core.math.affinematrix import AffineMatrix3D
    from source_tpu.core.scenegraph.node import World
    from source_tpu.optical.material.lambert import Lambert
    from source_tpu.primitive import Mesh
    from source_tpu.tracer.intersect import intersect_scene

    v, f = icosphere(2)
    w = World()
    m1 = np.eye(4)
    m1[:3, 3] = [1.5, 0.0, 0.0]
    m2 = np.eye(4)
    m2[:3, 3] = [-1.5, 0.2, 0.1]
    m2[0, 0] = -1.0
    for m in (m1, m2):
        Mesh(v, f, closed=True, parent=w, material=Lambert(),
             transform=AffineMatrix3D(m))
    s = compile_scene(w, SpectralConfig(400.0, 700.0, 4))
    assert len(s.meshes) == 2 and all(
        x.triangles.shape[0] <= meshtrace.DENSE_TRI_LIMIT for x in s.meshes)
    o, d = _rays("aimed", n=1024, seed=11)
    rec = jax.device_get(jax.jit(intersect_scene)(s, jnp.asarray(o), jnp.asarray(d)))
    t_min = 1e-4 * np.maximum(1.0, np.abs(o).max(1))
    best_t = np.full(len(o), np.inf)
    best_e = np.full(len(o), -1)
    for e, slot in s.mesh_entities:
        mesh = s.meshes[slot]
        w2l = np.asarray(mesh.w2l, np.float64)
        t, _, _, _, _ = all_pairs_reference(
            mesh.vertices, mesh.triangles, o @ w2l[:3, :3].T + w2l[:3, 3],
            d @ w2l[:3, :3].T, t_min)
        better = t < best_t
        best_t = np.where(better, t, best_t)
        best_e = np.where(better, e, best_e)
    hit = np.isfinite(best_t)
    assert (rec.hit == hit).mean() >= 0.998
    m = hit & rec.hit
    assert m.sum() > 100
    np.testing.assert_array_equal(rec.entity[m], best_e[m])
    np.testing.assert_allclose(rec.t[m], best_t[m], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_mesh_gradient_matches_finite_differences(route):
    """Both routes' hit distance differentiates w.r.t. the ray origin and
    the vertices like central differences of the reference."""
    mesh = _tables("icosphere2_smooth")
    n = 16
    rng = np.random.default_rng(5)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -2.5)], 1)
    d = np.tile([0.0, 0.0, 1.0], (n, 1))
    t_min = np.full(n, 1e-4)

    def loss(verts, o):
        m = dataclasses.replace(mesh, vertices=verts)
        r = _route(route, m, o, jnp.asarray(d, jnp.float32),
                   jnp.asarray(t_min, jnp.float32))
        return jnp.sum(jnp.where(r["tri"] >= 0, r["t"], 0.0))

    g_v, g_o = jax.grad(loss, argnums=(0, 1))(
        mesh.vertices, jnp.asarray(o, jnp.float32))
    g_v, g_o = np.asarray(g_v), np.asarray(g_o)
    verts = np.asarray(mesh.vertices, np.float64)
    tri0 = all_pairs_reference(verts, mesh.triangles, o, d, t_min)[1]

    def ref_loss(verts, o):
        t, tri = all_pairs_reference(verts, mesh.triangles, o, d, t_min)[:2]
        assert (tri == tri0).all()  # winners stable under the perturbation
        return np.where(tri >= 0, t, 0.0).sum()

    h = 1e-6
    for i, c in [(0, 0), (3, 2), (7, 1)]:
        up, dn = o.copy(), o.copy()
        up[i, c] += h
        dn[i, c] -= h
        fd = (ref_loss(verts, up) - ref_loss(verts, dn)) / (2 * h)
        assert abs(g_o[i, c] - fd) < 1e-3 * max(1.0, abs(fd))
    used = np.unique(np.asarray(mesh.triangles)[tri0[tri0 >= 0]])
    for vi in used[:4]:
        for c in range(3):
            up, dn = verts.copy(), verts.copy()
            up[vi, c] += h
            dn[vi, c] -= h
            fd = (ref_loss(up, o) - ref_loss(dn, o)) / (2 * h)
            assert abs(g_v[vi, c] - fd) < 1e-3 * max(1.0, abs(fd)), (vi, c)
