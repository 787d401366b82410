"""Named-colour emissive spheres — source_tpu counterpart of the reference's
demos/materials/colours_emissive.py: the colours_diffuse scene with the
spheres as UniformSurfaceEmitters over a brighter diffuse floor.

Run: JAX_PLATFORMS=cpu python demos/materials/colours_emissive.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere

from colours_diffuse import COLOURS  # noqa: E402  (same nine colours)


def build_world():
    world = World()
    angle, radius, distance = 6, 0.12, 3.2
    for i, colour in enumerate(COLOURS):
        increment = i - 4
        Sphere(radius, parent=world,
               transform=(rotate(increment * angle, 0, 0)
                          * translate(0, radius + 0.00001, distance)),
               material=UniformSurfaceEmitter(colour))
    Box(Point3D(-100, -0.1, -100), Point3D(100, 0, 100), parent=world,
        material=Lambert(ConstantSF(0.5)))
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
    camera.observe(seed=22)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "colours_emissive.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
