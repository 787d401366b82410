"""Analytic-scene leaf-count scaling microbench.

An L-sphere grid inside an emitting enclosure, 131k incoherent rays,
12 bounces, forward trace: rays/s vs total leaf count. The tracer streams
every leaf, so the cost is expected to grow linearly (ROADMAP S3); not
measured on the H100 yet. Prints one JSON line per grid size.

Usage: python benchmarks/leafscale.py
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_RAYS = 1 << 17
MAX_ITERS = 12
GRID_COUNTS = [32, 108, 256, 500, 1000]


def build_grid_world(n_spheres):
    from source_tpu.core.math.transform import translate
    from source_tpu.core.scenegraph import World
    from source_tpu.optical.material import (
        AbsorbingSurface, Lambert, UniformSurfaceEmitter,
    )
    from source_tpu.optical.spectrum import ConstantSF
    from source_tpu.primitive import Sphere

    w = World()
    Sphere(radius=40.0, parent=w,
           material=UniformSurfaceEmitter(ConstantSF(1.0)))
    side = max(1, round(n_spheres ** (1.0 / 3.0)))
    placed = 0
    spacing = 2.2
    half = 0.5 * (side - 1) * spacing
    for i in range(side):
        for j in range(side):
            for k in range(side):
                if placed >= n_spheres:
                    break
                mat = Lambert(ConstantSF(0.6)) if placed % 2 else AbsorbingSurface()
                Sphere(radius=0.8, parent=w,
                       transform=translate(i * spacing - half,
                                           j * spacing - half,
                                           k * spacing - half),
                       material=mat)
                placed += 1
    return w, placed + 1


def main():
    import jax
    import jax.numpy as jnp

    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import render_batch
    from source_tpu.runtime import enable_compile_cache
    from source_tpu.tracer.wavefront import RayConfig

    enable_compile_cache()
    key = jax.random.PRNGKey(0)
    d = jax.random.normal(key, (N_RAYS, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jax.random.normal(jax.random.fold_in(key, 1), (N_RAYS, 3)) * 3.0

    cfg = RayConfig(max_depth=MAX_ITERS, extinction_prob=0.1,
                    extinction_min_depth=3, importance_sampling=False,
                    max_iters=MAX_ITERS)

    for n in GRID_COUNTS:
        world, leaves = build_grid_world(n)
        scene = compile_scene(world, SpectralConfig(375.0, 740.0, 8))
        fn = jax.jit(lambda s, k: render_batch(s, cfg, o, d, k).segments)
        seg = fn(scene, key)
        jax.block_until_ready(seg)
        t0 = time.perf_counter()
        reps = 3
        for i in range(reps):
            seg = fn(scene, jax.random.PRNGKey(i + 1))
        jax.block_until_ready(seg)
        dt = (time.perf_counter() - t0) / reps
        rate = N_RAYS / dt
        seg_rate = int(seg) / dt
        print(json.dumps({
            "leaves": leaves, "wall_s": round(dt, 4),
            "rays_per_s": round(rate, 1),
            "segments_per_s": round(seg_rate, 1),
            "device_kind": jax.devices()[0].device_kind,
        }), flush=True)


if __name__ == "__main__":
    main()
