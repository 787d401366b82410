"""Prism dispersion demo — source_tpu counterpart of demos/prism.py.

White light through a slit strikes an equilateral SF11 prism; the
dispersed spectrum lands on the floor. Spectral parallelism: the camera
splits its wavelength range over many spectral rays so each traced ray
refracts with its own band-average index (dielectric.pyx:176-177
semantics — this is what makes the rainbow).

Run (GPU): python demos/prism.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/prism.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import Node, World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Subtract


def equilateral_prism(width=0.06, height=0.15, parent=None, transform=None,
                      material=None):
    """An equilateral prism along +y built by shaving two angled slabs off a
    rectangular bar (the reference's construction idea, demos/prism.py)."""
    half_width = width / 2
    mid_point = half_width / 2
    centre = Box(Point3D(-half_width * 1.001, 0, 0),
                 Point3D(half_width * 1.001, height, width))
    left = Box(
        Point3D(0, -0.001, 0), Point3D(width, height + 0.001, width * 2),
        transform=translate(half_width, 0, 0) * rotate(30, 0, 0),
    )
    right = Box(
        Point3D(-width, -0.001, 0), Point3D(0, height + 0.001, width * 2),
        transform=translate(-half_width, 0, 0) * rotate(-30, 0, 0),
    )
    prism = Subtract(Subtract(centre, left), right)
    prism.parent = parent
    prism.transform = (transform or translate(0, 0, 0)) * translate(0, 0, -mid_point)
    prism.material = material
    return prism


def light_box(parent, transform=None):
    """Collimated white source behind a slit."""
    node = Node(parent)
    if transform is not None:
        node.transform = transform
    outer = Box(Point3D(-0.01, 0, -0.05), Point3D(0.01, 0.15, 0.0))
    slit = Box(Point3D(-0.0015, 0.03, -0.045), Point3D(0.0015, 0.12, 0.0001))
    housing = Subtract(outer, slit)
    housing.parent = node
    housing.material = Lambert(ConstantSF(0.1))
    Box(Point3D(-0.0015, 0.03, -0.045), Point3D(0.0015, 0.12, -0.04),
        parent=node, material=UniformSurfaceEmitter(d65_white, 250))
    return node


def build_world():
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert())
    equilateral_prism(0.06, 0.15, parent=world, material=schott("SF11"),
                      transform=translate(0, 1e-6, -0.01))
    light_box(parent=world,
              transform=rotate(-35.5, 0, 0) * translate(0.10, 0, 0) * rotate(90, 0, 0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = PinholeCamera(
        (64, 36) if small else (512, 288), fov=45, parent=world,
        transform=translate(0, 0.075, -0.05) * rotate(180, -45, 0) * translate(0, 0, -0.75),
        pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 100
    camera.spectral_bins = 32
    camera.spectral_rays = 4 if small else 32  # dispersion needs slicing
    camera.ray_importance_sampling = True
    camera.ray_important_path_weight = 0.75
    camera.ray_max_depth = 16 if small else 100
    camera.max_wavefront_iters = 20 if small else 64

    t0 = time.time()
    camera.observe(seed=7)
    print(f"prism demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("prism_render.png")


if __name__ == "__main__":
    main()
