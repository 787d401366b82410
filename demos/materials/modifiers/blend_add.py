"""Modifier showcase: Blend and Add material mixes.

Counterparts of the reference's demos/materials/modifiers/{blend,add}.py —
left sphere: Blend(Lambert red, Gold, 0.5) probabilistic mix; right
sphere: Add(dim Lambert, dim emitter) summed response.

Run (GPU): python demos/materials/modifiers/blend_add.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/modifiers/blend_add.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF, InterpolatedSF
from source_tpu.optical.library import Gold, d65_white
from source_tpu.optical.material import (
    Add, Blend, Lambert, UniformSurfaceEmitter,
)
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.5)))
    red = InterpolatedSF([375, 580, 600, 740], [0.05, 0.05, 0.9, 0.9])
    Sphere(0.5, parent=world, transform=translate(-0.8, 0.5, 1.0),
           material=Blend(Lambert(red), Gold(), 0.5))
    Sphere(0.5, parent=world, transform=translate(0.8, 0.5, 1.0),
           material=Add(Lambert(ConstantSF(0.4)),
                        UniformSurfaceEmitter(d65_white, 0.4)))
    Box(Point3D(-3, 3.5, -2), Point3D(3, 3.7, 2), parent=world,
        material=UniformSurfaceEmitter(d65_white, 2.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.97)
    camera = PinholeCamera(
        (64, 48) if small else (512, 384), fov=45, parent=world,
        transform=translate(0, 1.0, -2.8) * rotate(0, -8, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 120
    camera.ray_max_depth = 8 if small else 24
    camera.max_wavefront_iters = 12 if small else 32

    t0 = time.time()
    camera.observe(seed=16)
    print(f"blend/add modifier demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("blend_add_render.png")


if __name__ == "__main__":
    main()
