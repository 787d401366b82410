"""Primitive showcase: the five spherical lens types imaging a source.

Counterpart of the reference's demos/primitives/spherical_lenses.py — a
BiConvex N-BK7 lens focuses a point-like emitter onto the camera while
the other lens types (BiConcave, PlanoConvex, PlanoConcave, Meniscus)
stand beside it.

Run (GPU): python demos/primitives/spherical_lenses.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/primitives/spherical_lenses.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box
from source_tpu.primitive.lens import (
    BiConcave, BiConvex, Meniscus, PlanoConcave, PlanoConvex,
)


def build_world():
    world = World()
    glass = schott("N-BK7")
    Box(Point3D(-10, -0.3, -10), Point3D(10, -0.28, 10), parent=world,
        material=Lambert(ConstantSF(0.4)))
    specs = [
        BiConvex(0.05, 0.012, 0.08, 0.08),
        BiConcave(0.05, 0.006, 0.08, 0.08),
        PlanoConvex(0.05, 0.01, 0.08),
        PlanoConcave(0.05, 0.006, 0.08),
        Meniscus(0.05, 0.008, 0.06, 0.1),
    ]
    for i, lens in enumerate(specs):
        lens.parent = world
        lens.transform = translate(-0.16 + i * 0.08, 0, 0.3) * rotate(0, 0, 0)
        lens.material = glass
    # bright backdrop panel behind the lenses
    Box(Point3D(-0.4, -0.2, 0.8), Point3D(0.4, 0.25, 0.82), parent=world,
        material=UniformSurfaceEmitter(d65_white, 2.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = PinholeCamera(
        (96, 32) if small else (768, 256), fov=40, parent=world,
        transform=translate(0, 0, -0.25), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 100
    camera.spectral_bins = 15
    camera.ray_max_depth = 12 if small else 40
    camera.max_wavefront_iters = 16 if small else 48

    t0 = time.time()
    camera.observe(seed=52)
    print(f"spherical lenses demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("spherical_lenses_render.png")


if __name__ == "__main__":
    main()
