"""Verify driver: exercise the public library surface end-to-end on the
CPU (JAX_PLATFORMS=cpu python dev/verify_driver.py); the GPU run is
chip_smoke.py."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

# 1. intersection sanity: hand-computable t through the PUBLIC api
from source_tpu import (World, Point3D, translate, compile_scene,
                        SpectralConfig, intersect_scene, RayConfig, trace_rays)
from source_tpu.primitive import Box, Sphere
from source_tpu.optical.material import Lambert, UnitySurfaceEmitter
from source_tpu.optical import ConstantSF

w = World()
Box(Point3D(-2, -2, 1), Point3D(2, 2, 1.5), parent=w, material=Lambert())
Sphere(0.5, parent=w, transform=translate(0, 0, -1), material=Lambert())
s = compile_scene(w, SpectralConfig(400, 700, 4))
o = jnp.asarray([[0.0, 0.0, -3.0]], jnp.float32)
d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
rec = intersect_scene(s, o, d)
t = float(rec.t[0])
assert abs(t - 1.5) < 1e-4, t  # sphere front face at z=-1.5
print("1. intersection sanity OK: t =", t)

# 2. furnace: rays inside a unity emitter sphere -> exactly 1.0/bin
from source_tpu.tracer.wavefront import init_rays
import jax
w2 = World()
Sphere(2.0, parent=w2, material=UnitySurfaceEmitter())
s2 = compile_scene(w2, SpectralConfig(400, 700, 4))
cfg = RayConfig(max_depth=4, extinction_prob=0.0, max_iters=4,
                importance_sampling=False)
rng = np.random.RandomState(0)
dirs = rng.normal(size=(512, 3)); dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
st = init_rays(jnp.zeros((512, 3), jnp.float32), jnp.asarray(dirs, jnp.float32), 4)
out = trace_rays(s2, cfg, st, jax.random.PRNGKey(0))
rad = np.asarray(out.radiance)
assert np.allclose(rad, 1.0, atol=1e-5), (rad.min(), rad.max())
print("2. furnace OK: all rays exactly 1.0")

# 3. lens (CSG) entity: hits land on the lens front surface
from demos.cornell_box import build_world
from source_tpu.primitive.lens.spherical import BiConvex
w4 = World()
lens = BiConvex(0.1, 0.02, 0.3, 0.3); lens.parent = w4
lens.transform = translate(0, 0, 0); lens.material = Lambert()
s4 = compile_scene(w4, SpectralConfig(400, 700, 4))
o4 = jnp.asarray(np.concatenate([rng.uniform(-.03,.03,(128,2)), np.full((128,1),-1.)],1), jnp.float32)
d4 = jnp.broadcast_to(jnp.asarray([0,0,1.], jnp.float32), (128,3))
r4 = intersect_scene(s4, o4, d4)
assert np.asarray(r4.hit).all() and not np.asarray(r4.exiting).any()
print("3. lens CSG OK:", int(np.asarray(r4.hit).sum()), "entering hits")

# 4. full observer render through the public pipeline API
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
rgb = RGBPipeline2D(accumulate=False)
cam = PinholeCamera((32, 32), parent=build_world(glass=True), pipelines=[rgb])
cam.transform = translate(0, 0, -3.3)
cam.pixel_samples = 16; cam.spectral_bins = 8; cam.quiet = True
cam.observe(seed=9)
fr = rgb.xyz_frame.mean
assert np.isfinite(fr).all() and fr[..., 1].mean() > 0.3
print("4. observer render OK: mean Y =", float(fr[..., 1].mean()))
print("ALL VERIFY FLOWS PASSED")
