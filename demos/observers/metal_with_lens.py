"""Measured metals through a physical lens camera — source_tpu counterpart
of the reference's demos/observers/metal_with_lens.py: six measured-n/k
metal spheres imaged by a TargetedCCDArray behind a BiConvex N-BK7 lens
inside an absorbing camera body with a null-material aperture target.

Run: JAX_PLATFORMS=cpu python demos/observers/metal_with_lens.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import Node, World
from source_tpu.optical import ConstantSF
from source_tpu.optical.colour import ciexyz_x, ciexyz_y, ciexyz_z
from source_tpu.optical.library import (
    Aluminium, Beryllium, Copper, Gold, Silver, Titanium, d65_white, schott,
)
from source_tpu.optical.material import (
    AbsorbingSurface, Lambert, NullMaterial, UniformSurfaceEmitter,
)
from source_tpu.optical.observer import (
    BayerPipeline2D, RGBPipeline2D, TargetedCCDArray,
)
from source_tpu.primitive import Box, Cylinder, Sphere, Subtract
from source_tpu.primitive.lens import BiConvex


def build_world():
    world = World()
    for (tx, tz), metal in [((1.2, 0.6), Gold), ((0.6, -0.6), Silver),
                            ((0, 0.6), Copper), ((-0.6, -0.6), Titanium),
                            ((-1.2, 0.6), Aluminium), ((0, -1.8), Beryllium)]:
        Sphere(0.5, parent=world, transform=translate(tx, 0.5001, tz),
               material=metal())
    Box(Point3D(-100, -0.1, -100), Point3D(100, 0, 100), parent=world,
        material=Lambert(ConstantSF(1.0)))
    Cylinder(3.0, 8.0, parent=world,
             transform=translate(4, 8, 0) * rotate(90, 0, 0),
             material=UniformSurfaceEmitter(d65_white, 1.0))

    camera = Node(parent=world, transform=translate(0, 4, -3.5) * rotate(0, -48, 180))
    BiConvex(0.0508, 0.0144, 0.0593, 0.0593, parent=camera,
             transform=translate(0, 0, 0.0536), material=schott("N-BK7"))
    Subtract(
        Subtract(Cylinder(0.0260, 0.07), Cylinder(0.0255, 0.06,
                                                  transform=translate(0, 0, 0.005))),
        Cylinder(0.015, 0.007, transform=translate(0, 0, 0.064)),
        parent=camera, transform=translate(0, 0, -0.01),
        material=AbsorbingSurface(),
    )
    aperture = Cylinder(0.016, 0.0009, parent=camera,
                        transform=translate(0, 0, 0.064),
                        material=NullMaterial())
    return world, camera, aperture


def main():
    small = "--small" in sys.argv
    world, camera, aperture = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98, name="sRGB")
    bayer = BayerPipeline2D(ciexyz_x, ciexyz_y, ciexyz_z,
                            display_unsaturated_fraction=0.98,
                            name="Bayer Filter")
    ccd = TargetedCCDArray(targets=[aperture], parent=camera,
                           pipelines=[rgb, bayer],
                           pixels=(90, 60) if small else (360, 240))
    ccd.pixel_samples = 16 if small else 250
    ccd.spectral_bins = 15 if small else 20
    ccd.ray_max_depth = 16 if small else 100
    ccd.observe(seed=17)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "metal_with_lens.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
