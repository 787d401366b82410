"""Copper torus over a diffuse floor — source_tpu counterpart of the
reference's demos/primitives/simple_torus.py (quartic torus intersection +
measured-metal conductor under a cylindrical strip light).

Run: JAX_PLATFORMS=cpu python demos/primitives/simple_torus.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import Copper, d65_white
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Cylinder, Torus


def build_world():
    world = World()
    Torus(1.0, 0.5, parent=world, transform=translate(0, 0.0, 0.6),
          material=Copper())
    Box(Point3D(-100, -100, -10), Point3D(100, 100, 0), parent=world,
        material=Lambert(ConstantSF(1.0)))
    Cylinder(3.0, 100.0, parent=world,
             transform=translate(0, 0, 8) * rotate(90, 0, 0) * translate(0, 0, -50),
             material=UniformSurfaceEmitter(d65_white, 1.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.995)
    camera = PinholeCamera(
        (64, 64) if small else (512, 512), parent=world,
        transform=rotate(0, 45, 0) * translate(0, 0, 5) * rotate(0, -180, 0),
        pipelines=[rgb])
    camera.spectral_bins = 21
    camera.pixel_samples = 16 if small else 250
    camera.ray_max_depth = 16 if small else 64
    camera.observe(seed=5)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "simple_torus.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
