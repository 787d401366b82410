"""Parabolic glass lens against a checkerboard — source_tpu counterpart of
the reference's demos/primitives/parabolic_lenses.py (Parabola primitive as
an N-BK7 refractor).

Run: JAX_PLATFORMS=cpu python demos/primitives/parabolic_lenses.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Checkerboard
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Parabola


def build_world():
    world = World()
    Parabola(radius=0.1, height=0.2, parent=world, material=schott("N-BK7"),
             transform=rotate(0, 100, 0))
    Box(Point3D(-50.0, -50.0, 50), Point3D(50.0, 50.0, 50.1), parent=world,
        material=Checkerboard(10, d65_white, d65_white, 0.4, 0.8))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D()
    camera = PinholeCamera((64, 64) if small else (256, 256), fov=45,
                           parent=world,
                           transform=translate(0.5, 0, -0.5) * rotate(45, 0, 0),
                           pipelines=[rgb])
    camera.pixel_samples = 16 if small else 50
    camera.spectral_bins = 20
    camera.ray_max_depth = 16 if small else 50
    camera.observe(seed=9)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "parabolic_lenses.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
