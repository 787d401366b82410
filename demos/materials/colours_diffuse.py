"""Named-colour diffuse spheres — source_tpu counterpart of the reference's
demos/materials/colours_diffuse.py: nine Lambert spheres in the library's
named top-hat colours, fanned in front of the camera under strip lights.

Run: JAX_PLATFORMS=cpu python demos/materials/colours_diffuse.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.library.spectra import (
    blue, cyan, green, light_blue, orange, purple, red, red_orange, yellow,
)
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Cylinder, Sphere

COLOURS = [yellow, orange, red_orange, red, purple, blue, light_blue, cyan, green]


def build_world(material_factory=None):
    material_factory = material_factory or Lambert
    world = World()
    angle, radius, distance = 6, 0.12, 3.2
    for i, colour in enumerate(COLOURS):
        increment = i - 4
        Sphere(radius, parent=world,
               transform=(rotate(increment * angle, 0, 0)
                          * translate(0, radius + 0.00001, distance)),
               material=material_factory(colour))
    Box(Point3D(-100, -0.1, -100), Point3D(100, 0, 100), parent=world,
        material=Lambert(ConstantSF(1 / 1000)))
    for z in (8, 6, 4, 2):
        Cylinder(0.5, 1.0, parent=world,
                 transform=translate(0.5, 5, z) * rotate(90, 0, 0),
                 material=UniformSurfaceEmitter(d65_white, 1.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(name="sRGB")
    camera = PinholeCamera((128, 64) if small else (512, 256), fov=42,
                           parent=world,
                           transform=translate(0, 3.3, 0) * rotate(0, -47, 0),
                           pipelines=[rgb])
    camera.spectral_bins = 25
    camera.pixel_samples = 16 if small else 250
    camera.ray_max_depth = 12 if small else 50
    camera.observe(seed=21)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "colours_diffuse.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
