"""CSG demo — source_tpu counterpart of the reference's demos/csg.py.

Renders the classic CSG test solid (sphere intersected with a cube minus
three orthogonal cylinders) in four dispersive glasses, over a checkerboard
backdrop inside a faint enclosure.

Run (GPU): python demos/csg.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/csg.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Checkerboard, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Cylinder, Intersect, Sphere, Subtract, Union


def _csg_solid():
    cyl_x = Cylinder(1, 4.2, transform=rotate(90, 0, 0) * translate(0, 0, -2.1))
    cyl_y = Cylinder(1, 4.2, transform=rotate(0, 90, 0) * translate(0, 0, -2.1))
    cyl_z = Cylinder(1, 4.2, transform=translate(0, 0, -2.1))
    cube = Box(Point3D(-1.5, -1.5, -1.5), Point3D(1.5, 1.5, 1.5))
    sphere = Sphere(2.0)
    return Intersect(sphere, Subtract(cube, Union(Union(cyl_x, cyl_y), cyl_z)))


def build_world():
    world = World()
    for (tx, ty, yaw, pitch), glass in [
        ((-2.1, 2.1, 30, -20), "N-LAK22"),
        ((2.1, 2.1, -30, -20), "SF10"),
        ((2.1, -2.1, -30, 20), "LF5"),
        ((-2.1, -2.1, 30, 20), "N-BK7"),
    ]:
        solid = _csg_solid()
        solid.parent = world
        solid.transform = translate(tx, ty, 2.5) * rotate(yaw, pitch, 0)
        solid.material = schott(glass)

    # lens-like union of two sphere caps
    s1 = Sphere(1.0, transform=translate(0, 0, 1.0 - 0.01))
    s2 = Sphere(0.5, transform=translate(0, 0, -0.5 + 0.01))
    lens = Intersect(s1, s2)
    lens.parent = world
    lens.transform = translate(0, 0, -3.6) * rotate(50, 50, 0)
    lens.material = schott("N-BK7")

    Box(Point3D(-50, -50, 50), Point3D(50, 50, 50.1), parent=world,
        material=Checkerboard(4, d65_white, d65_white, 0.4, 0.8))
    Box(Point3D(-100, -100, -100), Point3D(100, 100, 100), parent=world,
        material=UniformSurfaceEmitter(d65_white, 0.1))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = PinholeCamera(
        (64, 64) if small else (256, 256), fov=75, parent=world,
        transform=translate(0, 0, -4), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 250
    camera.spectral_bins = 15
    camera.ray_max_depth = 16 if small else 100
    camera.max_wavefront_iters = 20 if small else 64

    t0 = time.time()
    camera.observe(seed=42)
    print(f"csg demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("csg_render.png")


if __name__ == "__main__":
    main()
