"""Materials showcase: measured-metal spheres on a diffuse floor.

Counterpart of the reference's demos/materials/metal.py — a row of
spheres with the library's measured n/k conductors (gold, silver,
copper, aluminium, titanium) plus a rough variant, lit by a D65 panel.

Run (GPU): python demos/materials/metal.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/metal.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import (
    Aluminium, Copper, Gold, RoughGold, Silver, Titanium, d65_white,
)
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.5)))
    Box(Point3D(-10, 0, 6), Point3D(10, 10, 6.2), parent=world,
        material=Lambert(ConstantSF(0.3)))
    metals = [Gold(), Silver(), Copper(), Aluminium(), Titanium(), RoughGold(0.25)]
    for i, m in enumerate(metals):
        x = -2.5 + i * 1.0
        Sphere(0.45, parent=world, transform=translate(x, 0.45, 2.0), material=m)
    Box(Point3D(-4, 4, -2), Point3D(4, 4.2, 4), parent=world,
        material=UniformSurfaceEmitter(d65_white, 2.5))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96)
    camera = PinholeCamera(
        (64, 36) if small else (640, 360), fov=50, parent=world,
        transform=translate(0, 1.2, -3.2) * rotate(0, -8, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 150
    camera.ray_importance_sampling = True
    camera.ray_max_depth = 10 if small else 40
    camera.max_wavefront_iters = 14 if small else 48

    t0 = time.time()
    camera.observe(seed=6)
    print(f"metal demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("metal_render.png")


if __name__ == "__main__":
    main()
