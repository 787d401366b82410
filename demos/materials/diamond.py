"""Materials showcase: a high-dispersion dielectric gem on a checkerboard.

Counterpart of the reference's demos/materials/diamond.py — a faceted
dielectric solid with a diamond-like Sellmeier index (high dispersion)
rendered with spectral-ray slicing so the fire is visible.

Run (GPU): python demos/materials/diamond.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/diamond.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

import numpy as np

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Checkerboard, Dielectric, Lambert, Sellmeier, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere, Intersect


def diamond_material():
    # diamond Sellmeier coefficients (1-term approximation of the measured
    # dispersion curve; n(589nm) ~ 2.417)
    return Dielectric(
        index=Sellmeier(0.3306, 4.3356, 0.0, 175.0e-3 ** 2, 106.0e-3 ** 2, 0.0),
        transmission=ConstantSF(0.98),
    )


def gem(parent, material, transform=None):
    """Faceted solid: intersection of a sphere with angled half-space boxes."""
    solid = Sphere(0.5)
    for k in range(6):
        ang = k * 60.0
        cut = Box(Point3D(-1, -1, -1), Point3D(1, 1, 0.42),
                  transform=rotate(ang, 35, 0))
        solid = Intersect(solid, cut)
    solid = Intersect(solid, Box(Point3D(-1, -0.35, -1), Point3D(1, 1, 1)))
    solid.parent = parent
    solid.transform = transform
    solid.material = material
    return solid


def build_world():
    world = World()
    Box(Point3D(-10, -0.101, -10), Point3D(10, -0.1, 10), parent=world,
        material=Checkerboard(0.5, d65_white, d65_white, 0.05, 0.4))
    gem(world, diamond_material(), transform=translate(0, 0.26, 0) * rotate(0, 12, 0))
    Box(Point3D(-3, 3, -3), Point3D(3, 3.2, 3), parent=world,
        material=UniformSurfaceEmitter(d65_white, 3.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.95)
    camera = PinholeCamera(
        (64, 64) if small else (384, 384), fov=40, parent=world,
        transform=translate(0, 0.9, -2.4) * rotate(0, -16, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 4 if small else 80
    camera.spectral_bins = 16
    camera.spectral_rays = 2 if small else 16  # dispersion slicing
    camera.ray_max_depth = 12 if small else 64
    camera.max_wavefront_iters = 16 if small else 80

    t0 = time.time()
    camera.observe(seed=8)
    print(f"diamond demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("diamond_render.png")


if __name__ == "__main__":
    main()
