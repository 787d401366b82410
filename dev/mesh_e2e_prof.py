"""Profile the e2e mesh suite scene on the device: where does the time go?

Times (a) one warm observe() pass wall, (b) the raw jitted render_batch on a
flat ray batch of the same size, (c) the same batch with the two meshes
removed from the scene (analytic floor), to attribute mesh-kernel cost vs
everything else.
"""
import sys, time, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, n=5):
    fn()  # warm/compile
    ts = []
    for _ in range(n):
        t0 = time.time(); r = fn()
        jax.block_until_ready(r)
        ts.append(time.time() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from demos.mesh_render import build_world
    from source_tpu.core import rotate, translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import render_batch
    from source_tpu.tracer.wavefront import RayConfig

    world = build_world(small=True)
    rgb = RGBPipeline2D()
    camera = PinholeCamera((192, 192), fov=45, parent=world,
                           transform=translate(0, 1.0, -4.5) * rotate(0, -8, 0),
                           pipelines=[rgb])
    camera.pixel_samples = 32
    camera.spectral_bins = 12
    camera.ray_max_depth = 12
    camera.max_wavefront_iters = 16
    camera.compact_schedule = ((3, 4), (3, 4))
    camera.quiet = True

    camera.observe(seed=1)  # compile
    t0 = time.time(); camera.observe(seed=2); tp = time.time() - t0
    print(f"observe pass: {tp*1e3:.1f} ms  rays/s={camera.rays_per_second:.3g}")

    # raw batch through the same tracer
    spec = SpectralConfig(375.0, 740.0, 12)
    scene = compile_scene(world, spec)
    cfg = RayConfig(max_iters=16, max_depth=12,
                    compact_schedule=((3, 4), (3, 4)))
    n = 192 * 192 * 32
    key = jax.random.PRNGKey(0)
    o = jnp.tile(jnp.array([[0.0, 1.0, -4.5]], jnp.float32), (n, 1))
    kd = jax.random.normal(key, (n, 3))
    d = kd / jnp.linalg.norm(kd, axis=1, keepdims=True)
    f = jax.jit(lambda k: render_batch(scene, cfg, o, d, k))
    tm = timed(lambda: f(key))
    print(f"raw render_batch ({n} rays): {tm*1e3:.1f} ms")

    # analytic-only floor: same scene minus the meshes
    from demos.mesh_render import icosphere, torus_knot  # noqa: F401
    from source_tpu.core.scenegraph import World
    from source_tpu.primitive import Box
    from source_tpu.core import Point3D
    from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
    from source_tpu.optical import ConstantSF
    from source_tpu.optical.library import d65_white
    w2 = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=w2,
        material=Lambert(ConstantSF(0.6)))
    Box(Point3D(-10, 0, 4), Point3D(10, 6, 4.1), parent=w2,
        material=Lambert(ConstantSF(0.3)))
    Box(Point3D(-1.5, 3.0, -1.5), Point3D(1.5, 3.2, 1.5), parent=w2,
        material=UniformSurfaceEmitter(d65_white, 4.0))
    s2 = compile_scene(w2, spec)
    f2 = jax.jit(lambda k: render_batch(s2, cfg, o, d, k))
    tm2 = timed(lambda: f2(key))
    print(f"analytic-only render_batch: {tm2*1e3:.1f} ms")


if __name__ == "__main__":
    main()
