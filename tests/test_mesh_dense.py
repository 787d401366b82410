"""The dense all-pairs mesh test (`mesh_forest_intersect`, here on one
mesh with an identity transform) must agree with the stackless BVH walk
(same t/u/v/front/winner up to f32 tie-breaks) and stay differentiable
w.r.t. vertices."""

import numpy as np
import jax
import jax.numpy as jnp

from source_tpu.primitive.mesh.data import MeshData
from source_tpu.tracer.meshtrace import (
    _mesh_intersect_xla_diff, mesh_forest_intersect,
)


def _dense(mesh, o, d, t_min):
    return mesh_forest_intersect([mesh], o, d, t_min)[0]


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return verts, faces


def _tables():
    verts, faces = _icosahedron()
    md = MeshData(verts, faces, smoothing=False)
    return md.to_tables(np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))


def _rays(n=512, seed=0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def test_dense_matches_xla_path():
    mesh = _tables()
    o, d = _rays()
    t_min = jnp.zeros(o.shape[0], jnp.float32)
    ref = _mesh_intersect_xla_diff(mesh, o, d, t_min)
    got = _dense(mesh, o, d, t_min)

    hit_ref = np.asarray(ref["tri"] >= 0)
    hit_got = np.asarray(got["tri"] >= 0)
    # identical hit set (allow f32 grazing-edge flips on none of 512 rays)
    assert (hit_ref == hit_got).all()
    m = hit_ref
    np.testing.assert_allclose(
        np.asarray(got["t"])[m], np.asarray(ref["t"])[m], rtol=2e-5, atol=2e-5
    )
    assert (np.asarray(got["front"])[m] == np.asarray(ref["front"])[m]).all()
    # same winning triangle everywhere the hits are unambiguous
    same = np.asarray(got["tri"])[m] == np.asarray(ref["tri"])[m]
    assert same.mean() > 0.99
    np.testing.assert_allclose(
        np.asarray(got["u"])[m][same], np.asarray(ref["u"])[m][same],
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got["v"])[m][same], np.asarray(ref["v"])[m][same],
        rtol=1e-4, atol=1e-4,
    )


def test_dense_respects_t_min():
    mesh = _tables()
    o, d = _rays(64, seed=3)
    t_min = jnp.zeros(64, jnp.float32)
    first = _dense(mesh, o, d, t_min)
    m = np.asarray(first["tri"] >= 0)
    # re-march from just past the first hit: second hit must be farther
    second = _dense(mesh, o, d, first["t"] + 1e-4)
    hit2 = np.asarray(second["tri"] >= 0)
    assert (np.asarray(second["t"])[m & hit2] >
            np.asarray(first["t"])[m & hit2]).all()


def test_forest_matches_per_mesh():
    """One merged world-space forest call must agree with per-mesh local
    traversal, including a mirrored (negative-determinant) instance."""
    import jax.numpy as jnp
    from source_tpu.core.math import batch as vmath
    import dataclasses

    verts, faces = _icosahedron()
    md = MeshData(verts, faces, smoothing=False)

    def frames(mat):
        w2l = np.linalg.inv(mat).astype(np.float32)
        return w2l, mat.astype(np.float32)

    t1 = np.eye(4); t1[:3, 3] = [1.5, 0.0, 0.0]
    t2 = np.eye(4); t2[:3, 3] = [-1.5, 0.2, 0.1]
    t2[0, 0] = -1.0  # mirrored instance
    meshes = [md.to_tables(*frames(t)) for t in (t1, t2)]

    o, d = _rays(1024, seed=11)
    t_min = jnp.zeros(1024, jnp.float32)
    forest = mesh_forest_intersect(meshes, o, d, t_min)

    for mesh, got in zip(meshes, forest):
        o_loc = vmath.transform_point(mesh.w2l[None], o)
        d_loc = vmath.transform_vector(mesh.w2l[None], d)
        ref = _mesh_intersect_xla_diff(mesh, o_loc, d_loc, t_min)
        # attribution: the forest assigns each ray to the globally nearest
        # mesh, so compare only where this mesh wins or both miss
        hit_ref = np.asarray(ref["tri"] >= 0)
        hit_got = np.asarray(got["tri"] >= 0)
        m = hit_got  # forest claims this mesh won
        assert hit_ref[m].all()  # every claimed win is a real local hit
        np.testing.assert_allclose(
            np.asarray(got["t"])[m], np.asarray(ref["t"])[m],
            rtol=5e-4, atol=5e-4,
        )
        same = np.asarray(got["tri"])[m] == np.asarray(ref["tri"])[m]
        assert same.mean() > 0.99
        assert (np.asarray(got["front"])[m][same]
                == np.asarray(ref["front"])[m][same]).all()


def test_dense_gradients_flow_to_vertices():
    mesh = _tables()
    o, d = _rays(128, seed=7)
    t_min = jnp.zeros(128, jnp.float32)

    def loss(verts):
        import dataclasses
        m2 = dataclasses.replace(mesh, vertices=verts)
        res = _dense(m2, o, d, t_min)
        hit = res["tri"] >= 0
        return jnp.sum(jnp.where(hit, res["t"], 0.0))

    g = jax.grad(loss)(mesh.vertices)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
