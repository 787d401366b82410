"""Lens-stack scaling: rays/s vs the number of CSG lens entities.

A lens-stack scene (the reference's cooke-triplet geometry class — every
lens is a CSG of spheres/cylinders, raysect/primitive/lens/spherical.pyx:
46-466). The reference's kd-tree makes its cost sublinear in lens count
(core/acceleration/kdtree.pyx:41-180); the tracer streams every leaf, so
its cost grows linearly (ROADMAP S3).

Protocol (mirrors benchmarks/leafscale.py): an LxL grid of BiConvex
lenses, 131k rays aimed at random lenses, 8 bounces through the full
trace_rays wavefront (Lambert material so paths scatter), median of 3
timed repeats per point. Prints one JSON line per grid size.

Usage: python benchmarks/lensscale.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRIDS = (2, 4, 6, 8)  # 4, 16, 36, 64 lenses
N_RAYS = 1 << 17
BOUNCES = 8
REPEATS = 3


def build(n_side):
    import numpy as np

    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.core.math.transform import translate
    from source_tpu.core.scenegraph.node import World
    from source_tpu.optical.material.lambert import Lambert
    from source_tpu.primitive.lens.spherical import BiConvex

    w = World()
    for i in range(n_side):
        for j in range(n_side):
            lens = BiConvex(0.1, 0.02, 0.3, 0.3)
            lens.parent = w
            lens.transform = translate(0.35 * i, 0.35 * j, 0.0)
            lens.material = Lambert()
    return compile_scene(w, SpectralConfig(400.0, 700.0, 8))


def measure(scene, n_side):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from source_tpu.tracer.wavefront import RayConfig, init_rays, trace_rays

    rng = np.random.RandomState(0)
    span = 0.35 * n_side
    tgt = rng.uniform(0, span, (N_RAYS, 2))
    o = np.concatenate(
        [tgt + rng.normal(scale=0.05, size=(N_RAYS, 2)),
         np.full((N_RAYS, 1), -1.5)], axis=1)
    d = np.concatenate([tgt, np.zeros((N_RAYS, 1))], axis=1) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    cfg = RayConfig(max_depth=BOUNCES, extinction_prob=0.1,
                    extinction_min_depth=3, importance_sampling=False,
                    max_iters=BOUNCES, early_exit=False)
    key = jax.random.PRNGKey(0)
    run = jax.jit(lambda o, d: trace_rays(
        scene, cfg, init_rays(o, d, scene.bins), key))
    out = run(o, d)
    jax.block_until_ready(out.radiance)
    segments = int(out.segments)
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = run(o, d)
        jax.block_until_ready(out.radiance)
        times.append(time.perf_counter() - t0)
    times.sort()
    return segments / times[len(times) // 2], times


def main():
    import jax

    from source_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    for n_side in GRIDS:
        rate, times = measure(build(n_side), n_side)
        print(json.dumps({"lenses": n_side * n_side, "rays_per_s": round(rate, 1),
                          "times_s": [round(t, 4) for t in times],
                          "device_kind": jax.devices()[0].device_kind}),
              flush=True)


if __name__ == "__main__":
    main()
