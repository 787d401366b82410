"""Cornell box through a REAL pinhole — source_tpu counterpart of the
reference's demos/observers/cornell_box_real_pinhole.py: a physical
camera-obscura (absorbing box with a small null-material hole) imaging
onto a CCDArray, rather than the ideal PinholeCamera model.

Run: JAX_PLATFORMS=cpu python demos/observers/cornell_box_real_pinhole.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from demos.cornell_box import build_world
from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import Node
from source_tpu.optical.material import AbsorbingSurface, NullMaterial
from source_tpu.optical.observer import RGBPipeline2D, TargetedCCDArray
from source_tpu.primitive import Box, Cylinder, Subtract


def build_camera(world, hole_radius=0.002):
    camera = Node(parent=world, transform=translate(0, 0, -3.2))
    # camera-obscura body: hollow absorbing box with a hole in the front
    Subtract(
        Subtract(
            Box(Point3D(-0.05, -0.05, -0.20), Point3D(0.05, 0.05, 0.0)),
            Box(Point3D(-0.048, -0.048, -0.198), Point3D(0.048, 0.048, -0.002)),
        ),
        Cylinder(hole_radius, 0.004, transform=translate(0, 0, -0.003)),
        parent=camera, material=AbsorbingSurface(),
    )
    aperture = Cylinder(hole_radius, 0.0019, parent=camera,
                        transform=translate(0, 0, -0.0025),
                        material=NullMaterial())
    image_plane = Node(parent=camera, transform=translate(0, 0, -0.19))
    return image_plane, aperture


def main():
    small = "--small" in sys.argv
    world = build_world(glass=False)
    image_plane, aperture = build_camera(world)
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96, name="sRGB")
    ccd = TargetedCCDArray(targets=[aperture], parent=image_plane,
                           transform=rotate(0, 0, 180),
                           pipelines=[rgb],
                           pixels=(64, 64) if small else (256, 256),
                           width=0.08)
    ccd.pixel_samples = 8 if small else 400
    ccd.spectral_bins = 12 if small else 15
    ccd.ray_max_depth = 16 if small else 100
    ccd.observe(seed=33)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "cornell_box_real_pinhole.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
