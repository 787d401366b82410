"""Primitive showcase: every analytic primitive type in one scene.

Counterpart of the reference's demos/primitives/raysect_primitives.py —
sphere, box, cylinder, cone, parabola and torus in a row, plus a CSG
sample, on a checkerboard floor.

Run (GPU): python demos/primitives/all_primitives.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/primitives/all_primitives.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Checkerboard, Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import (
    Box, Cone, Cylinder, Parabola, Sphere, Subtract, Torus,
)


def build_world():
    world = World()
    Box(Point3D(-20, -0.101, -20), Point3D(20, -0.1, 20), parent=world,
        material=Checkerboard(0.6, d65_white, d65_white, 0.08, 0.35))
    grey = Lambert(ConstantSF(0.6))
    Sphere(0.4, parent=world, transform=translate(-2.5, 0.3, 1.5), material=grey)
    Box(Point3D(-0.3, -0.3, -0.3), Point3D(0.3, 0.3, 0.3), parent=world,
        transform=translate(-1.5, 0.2, 1.5) * rotate(30, 0, 0), material=grey)
    Cylinder(0.3, 0.6, parent=world,
             transform=translate(-0.5, -0.1, 1.5) * rotate(0, -90, 0), material=grey)
    Cone(0.3, 0.7, parent=world,
         transform=translate(0.5, -0.1, 1.5) * rotate(0, -90, 0), material=grey)
    Parabola(0.3, 0.5, parent=world,
             transform=translate(1.5, -0.1, 1.5) * rotate(0, -90, 0), material=grey)
    Torus(0.3, 0.1, parent=world,
          transform=translate(2.5, 0.0, 1.5) * rotate(0, -90, 0), material=grey)
    Subtract(
        Box(Point3D(-0.25, -0.25, -0.25), Point3D(0.25, 0.25, 0.25)),
        Sphere(0.32),
        parent=world, transform=translate(0, 0.2, 0.2) * rotate(25, 15, 0),
        material=grey,
    )
    Box(Point3D(-4, 4, -2), Point3D(4, 4.2, 4), parent=world,
        material=UniformSurfaceEmitter(d65_white, 2.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.97)
    camera = PinholeCamera(
        (96, 40) if small else (768, 320), fov=55, parent=world,
        transform=translate(0, 1.3, -2.6) * rotate(0, -16, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 100
    camera.ray_max_depth = 8 if small else 24
    camera.max_wavefront_iters = 12 if small else 32

    t0 = time.time()
    camera.observe(seed=51)
    print(f"all-primitives demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("all_primitives_render.png")


if __name__ == "__main__":
    main()
