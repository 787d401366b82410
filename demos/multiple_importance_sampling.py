"""Multiple importance sampling demo — counterpart of the reference's
demos/multiple_importance_sampling.py (Veach-style scene): rows of
increasingly rough mirrors under emitters of decreasing size but equal
power. One-sample MIS between BSDF and light sampling keeps both the
small-bright and large-dim lights converging.

Run (GPU): python demos/multiple_importance_sampling.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/multiple_importance_sampling.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Lambert, RoughConductor, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()

    # floor and backdrop
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.5)))
    Box(Point3D(-10, 0, 4), Point3D(10, 10, 4.1), parent=world,
        material=Lambert(ConstantSF(0.2)))

    # four spheres of equal emitted power, radii decreasing 4x each step
    radii = [0.5, 0.125, 0.03125, 0.0078125]
    for i, r in enumerate(radii):
        scale = (radii[0] / r) ** 2  # constant total power
        Sphere(r, parent=world, transform=translate(-1.8 + 1.2 * i, 2.2, 2.0),
               material=UniformSurfaceEmitter(d65_white, scale))

    # four tilted metal plates of increasing roughness
    n = ConstantSF(0.9)
    k = ConstantSF(6.0)
    for i, rough in enumerate([0.02, 0.05, 0.15, 0.4]):
        Box(Point3D(-2.4, -0.02, -0.3), Point3D(2.4, 0.0, 0.3), parent=world,
            transform=translate(0, 0.35 + 0.45 * i, 0.6 + 0.6 * i) * rotate(0, 62 - 8 * i, 0),
            material=RoughConductor(n, k, rough))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96)
    camera = PinholeCamera(
        (64, 48) if small else (512, 384), fov=45, parent=world,
        transform=translate(0, 1.2, -3.5) * rotate(0, -5, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 200
    camera.spectral_bins = 12
    camera.ray_importance_sampling = True
    camera.ray_important_path_weight = 0.3
    camera.ray_max_depth = 12 if small else 50
    camera.max_wavefront_iters = 16 if small else 60

    t0 = time.time()
    camera.observe(seed=99)
    print(f"MIS demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("mis_render.png")


if __name__ == "__main__":
    main()
