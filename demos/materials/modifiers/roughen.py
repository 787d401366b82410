"""Modifier showcase: Roughen over a gold conductor.

Counterpart of the reference's demos/materials/modifiers/roughen.py — a
row of gold spheres with increasing Roughen() roughness, showing the
mirror highlight spreading into a glossy lobe.

Run (GPU): python demos/materials/modifiers/roughen.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/modifiers/roughen.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import Gold, d65_white
from source_tpu.optical.material import Lambert, Roughen, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.5)))
    for i, rough in enumerate([0.0, 0.12, 0.3, 0.6]):
        mat = Gold() if rough == 0.0 else Roughen(Gold(), rough)
        Sphere(0.45, parent=world, transform=translate(-2.1 + i * 1.4, 0.45, 1.2),
               material=mat)
    Box(Point3D(-3, 3.5, -2), Point3D(3, 3.7, 2), parent=world,
        material=UniformSurfaceEmitter(d65_white, 3.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96)
    camera = PinholeCamera(
        (96, 32) if small else (640, 240), fov=50, parent=world,
        transform=translate(0, 1.0, -3.0) * rotate(0, -6, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 120
    camera.ray_max_depth = 8 if small else 24
    camera.max_wavefront_iters = 12 if small else 32

    t0 = time.time()
    camera.observe(seed=15)
    print(f"roughen modifier demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("roughen_render.png")


if __name__ == "__main__":
    main()
