"""Quickstart: a Lambert sphere under an emitting ceiling panel.

Counterpart of the reference's demos/quickstart/lambert.py — the minimal
"build a scene, point a camera, observe" script.

Run (GPU): python demos/quickstart/lambert.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/quickstart/lambert.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    Sphere(0.5, parent=world, transform=translate(0, 0.5001, 0),
           material=Lambert(ConstantSF(0.6)))
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.4)))
    Box(Point3D(-1, 3, -1), Point3D(1, 3.1, 1), parent=world,
        material=UniformSurfaceEmitter(d65_white, 4.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = PinholeCamera(
        (64, 64) if small else (384, 384), fov=45, parent=world,
        transform=translate(0, 1.2, -3.5) * rotate(0, -8, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 100
    camera.ray_max_depth = 8 if small else 32
    camera.max_wavefront_iters = 12 if small else 40

    t0 = time.time()
    camera.observe(seed=1)
    print(f"lambert quickstart rendered in {time.time() - t0:0.1f}s")
    rgb.save("lambert_render.png")


if __name__ == "__main__":
    main()
