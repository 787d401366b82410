"""Torus-grid leaf scaling: rays/s vs torus count. Grid of tori inside an
emitting enclosure, 131k incoherent rays, 8 bounces, forward trace. Every
torus leaf is streamed (a quartic per ray per torus), so the cost grows
linearly in torus count (ROADMAP S3); not measured on the H100 yet.
Prints one JSON line per grid size.

Usage: python benchmarks/torusscale.py
"""
import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_RAYS = 1 << 17
MAX_ITERS = 8
GRID_COUNTS = [27, 125, 343]


def build_grid_world(n_tori):
    from source_tpu.core.math.transform import rotate_x, translate
    from source_tpu.core.scenegraph import World
    from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
    from source_tpu.optical.spectrum import ConstantSF
    from source_tpu.primitive import Sphere, Torus

    w = World()
    Sphere(radius=60.0, parent=w,
           material=UniformSurfaceEmitter(ConstantSF(1.0)))
    side = max(1, round(n_tori ** (1.0 / 3.0)))
    spacing = 2.6
    half = 0.5 * (side - 1) * spacing
    placed = 0
    for i in range(side):
        for j in range(side):
            for k in range(side):
                if placed >= n_tori:
                    break
                Torus(0.7, 0.2, parent=w,
                      transform=translate(i * spacing - half,
                                          j * spacing - half,
                                          k * spacing - half)
                      * rotate_x(20.0 * ((i + j + k) % 5)),
                      material=Lambert())
                placed += 1
    return w


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import render_batch
    from source_tpu.runtime import enable_compile_cache
    from source_tpu.tracer.wavefront import RayConfig

    enable_compile_cache()
    key = jax.random.PRNGKey(0)
    for n_tori in GRID_COUNTS:
        scene = compile_scene(build_grid_world(n_tori),
                              SpectralConfig(400.0, 700.0, 4))
        cfg = RayConfig(max_depth=MAX_ITERS, max_iters=MAX_ITERS,
                        extinction_prob=0.1, extinction_min_depth=2,
                        compact_schedule=(), early_exit=False)
        side_len = 0.5 * (round(n_tori ** (1 / 3.0))) * 2.6 + 2.0
        u = jax.random.uniform(key, (N_RAYS, 3)) * 2.0 - 1.0
        o = u * side_len
        d = jax.random.normal(jax.random.fold_in(key, 1), (N_RAYS, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        fwd = jax.jit(lambda s, k: render_batch(s, cfg, o, d, k).segments)

        seg = int(fwd(scene, key))
        ts = []
        for g in range(3):
            t0 = time.perf_counter()
            outs = [fwd(scene, jax.random.fold_in(key, 10 + g * 5 + i))
                    for i in range(3)]
            jax.block_until_ready(outs)
            ts.append((time.perf_counter() - t0) / 3)
        dt = min(ts)
        print(json.dumps({
            "tori": n_tori, "rays_per_s": round(N_RAYS * MAX_ITERS / dt, 1),
            "segments_per_s": round(seg / dt, 1), "wall_ms": round(dt * 1e3, 2),
            "device_kind": jax.devices()[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
