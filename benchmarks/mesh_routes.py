"""Dense all-pairs mesh test vs the threaded-BVH walk, on one device.

For meshes of 1,280 to 8,192 triangles, times the one-mesh dense call
(``mesh_forest_intersect``) against the BVH walk (``mesh_intersect``) at
131,072 rays. Then a 12-bounce forward trace (``render_batch``) of the
suite's two-mesh scene (``demos/mesh_render.build_world(small=True)``),
where ``intersect_scene`` routes both meshes into one dense call while
they are within ``meshtrace.DENSE_TRI_LIMIT``; it runs once with the limit
above the mesh sizes (dense) and once at 0 (BVH).

Usage: python benchmarks/mesh_routes.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_RAYS = 1 << 17
REPEATS = 5


def _median_ms(fn):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[len(ts) // 2]


def meshes():
    from benchmarks.bigmesh import icosphere
    from demos.mesh_render import torus_knot

    return {
        "icosphere_1280": icosphere(3),
        "torus_knot_2048": torus_knot(segments=128, sides=8),
        "torus_knot_3072": torus_knot(segments=192, sides=8),
        "torus_knot_4096": torus_knot(segments=256, sides=8),
        "icosphere_5120": icosphere(4),
        "torus_knot_8192": torus_knot(segments=256, sides=16),
    }


def main():
    import jax
    import jax.numpy as jnp

    from demos.mesh_render import build_world
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import render_batch
    from source_tpu.primitive.mesh.data import MeshData
    from source_tpu.runtime import enable_compile_cache
    from source_tpu.tracer import meshtrace
    from source_tpu.tracer.wavefront import RayConfig

    enable_compile_cache()
    limit = meshtrace.DENSE_TRI_LIMIT
    key = jax.random.PRNGKey(0)
    d = jax.random.normal(key, (N_RAYS, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jax.random.uniform(jax.random.fold_in(key, 1), (N_RAYS, 3),
                           minval=-3.0, maxval=3.0)
    tmin = jnp.full((N_RAYS,), 1e-4, jnp.float32)

    for name, (v, f) in meshes().items():
        tables = MeshData(v, f, smoothing=True, closed=True).to_tables(
            np.eye(4), np.eye(4))
        row = {"case": "one_mesh", "mesh": name, "tris": int(len(f))}
        row["dense_ms"] = _median_ms(jax.jit(
            lambda: meshtrace.mesh_forest_intersect([tables], o, d, tmin)[0]["t"]))
        row["bvh_ms"] = _median_ms(jax.jit(
            lambda: meshtrace.mesh_intersect(tables, o, d, tmin)["t"]))
        print(json.dumps(row), flush=True)

    scene = compile_scene(build_world(small=True), SpectralConfig(375., 740., 12))
    cam_o = jnp.broadcast_to(jnp.asarray([0.0, 1.0, -4.5], jnp.float32),
                             (N_RAYS, 3))
    u = jax.random.uniform(jax.random.fold_in(key, 2), (N_RAYS, 2))
    cam_d = jnp.stack([(u[:, 0] - .5) * .8, (u[:, 1] - .5) * .8 - .15,
                       jnp.ones(N_RAYS)], -1)
    cam_d = cam_d / jnp.linalg.norm(cam_d, axis=-1, keepdims=True)
    suite_cfg = RayConfig(max_depth=12, max_iters=16,
                          compact_schedule=((2, 8), (3, 4)))
    row = {"case": "trace_rays", "mesh": "suite_two_meshes",
           "tris": [int(m.triangles.shape[0]) for m in scene.meshes]}
    for route, lim in (("dense", 1 << 30), ("bvh", 0)):
        meshtrace.DENSE_TRI_LIMIT = lim
        row[f"{route}_ms"] = _median_ms(jax.jit(lambda: render_batch(
            scene, suite_cfg, cam_o, cam_d, key).radiance))
    meshtrace.DENSE_TRI_LIMIT = limit
    print(json.dumps(row), flush=True)
    print(json.dumps({"device_kind": jax.devices()[0].device_kind,
                      "rays": N_RAYS, "repeats": REPEATS}))


if __name__ == "__main__":
    main()
