"""Large-mesh intersection benchmark: a 1.31M-triangle icosphere, 131k rays
through ``mesh_intersect`` (the threaded-BVH walk).

Not measured on the H100 yet; ``chip_smoke.py`` drives the same mesh and
checks it against an all-pairs reference.

Usage: python benchmarks/bigmesh.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SUBDIVISIONS = 8  # 20 * 4**8 = 1,310,720 triangles
N_RAYS = 1 << 17


def icosphere(subdivisions, radius=1.0):
    """Closed subdivided icosahedron, built in bulk with numpy (each level
    splits every edge once: edges are keyed as ``lo * V + hi`` and
    deduplicated with ``np.unique``). Returns f32 vertices [V,3] and i32
    triangles [20 * 4**subdivisions, 3]."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        n_v, n_f = len(verts), len(faces)
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                                np.stack([c, a], 1)])
        lo, hi = edges.min(axis=1), edges.max(axis=1)
        keys, inv = np.unique(lo * n_v + hi, return_inverse=True)
        mid = verts[keys // n_v] + verts[keys % n_v]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        verts = np.concatenate([verts, mid])
        ab, bc, ca = (n_v + inv[:n_f], n_v + inv[n_f:2 * n_f],
                      n_v + inv[2 * n_f:])
        faces = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def rays(n, seed=0):
    """Camera-like fan from z = -3 toward the sphere (most rays hit)."""
    import jax
    import jax.numpy as jnp

    u = jax.random.uniform(jax.random.PRNGKey(seed), (n, 2))
    d = jnp.stack([(u[:, 0] - 0.5) * 1.2, (u[:, 1] - 0.5) * 1.2,
                   jnp.ones(n)], -1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(jnp.asarray([0., 0., -3.], jnp.float32), (n, 3))
    return o, d, jnp.zeros(n, jnp.float32)


def main():
    import jax

    from source_tpu.primitive.mesh.data import MeshData
    from source_tpu.runtime import enable_compile_cache
    from source_tpu.tracer.meshtrace import mesh_intersect

    enable_compile_cache()
    t0 = time.perf_counter()
    v, f = icosphere(SUBDIVISIONS)
    tables = MeshData(v, f, smoothing=True, closed=True).to_tables(
        np.eye(4), np.eye(4))
    print(f"mesh: {len(f)} tris, build {time.perf_counter() - t0:.1f}s",
          flush=True)
    o, d, tmin = rays(N_RAYS)
    fn = jax.jit(lambda: mesh_intersect(tables, o, d, tmin))
    jax.block_until_ready(fn())
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{jax.devices()[0].device_kind}: {dt * 1e3:.2f} ms -> "
          f"{N_RAYS / dt / 1e6:.2f} M rays/s", flush=True)


if __name__ == "__main__":
    main()
