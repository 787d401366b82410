"""Cornell Box demo — source_tpu counterpart of the reference's
demos/cornell_box.py. Renders the classic Cornell Box with the measured
wall reflectivities and light spectrum, a glass box and a glass sphere.

Run (GPU): python demos/cornell_box.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/cornell_box.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

import numpy as np

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import Node, World
from source_tpu.primitive import Box, Sphere
from source_tpu.optical import InterpolatedSF
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.library import schott
from source_tpu.optical.observer import (
    PinholeCamera, RGBPipeline2D, PowerPipeline2D, RGBAdaptiveSampler2D,
)


def build_world(glass=True):
    # measured Cornell-box wall reflectivities (public data,
    # graphics.cornell.edu/online/box/data.html), decimated to 20 nm
    wavelengths = np.arange(400, 701, 20)
    white = np.array([0.343, 0.665, 0.745, 0.751, 0.748, 0.753, 0.735,
                      0.725, 0.732, 0.733, 0.754, 0.734, 0.755, 0.744,
                      0.712, 0.727])[: len(wavelengths)]
    green = np.array([0.092, 0.098, 0.097, 0.107, 0.125, 0.229, 0.472,
                      0.481, 0.447, 0.373, 0.337, 0.266, 0.186, 0.141,
                      0.123, 0.114])[: len(wavelengths)]
    red = np.array([0.040, 0.049, 0.057, 0.062, 0.060, 0.058, 0.057,
                    0.059, 0.061, 0.067, 0.090, 0.255, 0.402, 0.487,
                    0.620, 0.609])[: len(wavelengths)]

    white_reflectivity = InterpolatedSF(wavelengths, white)
    red_reflectivity = InterpolatedSF(wavelengths, red)
    green_reflectivity = InterpolatedSF(wavelengths, green)
    light_spectrum = InterpolatedSF([400, 500, 600, 700], [0.0, 8.0, 15.6, 18.4])

    world = World()
    enclosure = Node(world)

    # enclosing box walls (unit panels transformed like the reference demo)
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, 0, 1) * rotate(0, 0, 0),
        material=Lambert(white_reflectivity), name="back")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, -1, 0) * rotate(0, -90, 0),
        material=Lambert(white_reflectivity), name="floor")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, 1, 0) * rotate(0, 90, 0),
        material=Lambert(white_reflectivity), name="ceiling")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(1, 0, 0) * rotate(-90, 0, 0),
        material=Lambert(red_reflectivity), name="left")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(-1, 0, 0) * rotate(90, 0, 0),
        material=Lambert(green_reflectivity), name="right")

    # ceiling light
    Box(Point3D(-0.4, -0.4, -0.01), Point3D(0.4, 0.4, 0.0), parent=enclosure,
        transform=translate(0, 1, 0) * rotate(0, 90, 0),
        material=UniformSurfaceEmitter(light_spectrum, 2), name="light")

    # objects
    if glass:
        box_mat = schott("N-BK7")
        sphere_mat = schott("N-BK7")
    else:
        box_mat = Lambert(white_reflectivity)
        sphere_mat = Lambert(white_reflectivity)
    Box(Point3D(-0.4, 0, -0.4), Point3D(0.3, 1.4, 0.3), parent=world,
        transform=translate(0.4, -1 + 1e-6, 0.4) * rotate(30, 0, 0),
        material=box_mat, name="glass box")
    Sphere(0.4, parent=world,
           transform=translate(-0.4, -0.6 + 1e-6, -0.4) * rotate(0, 0, 0),
           material=sphere_mat, name="glass sphere")
    return world


def main():
    small = "--small" in sys.argv
    size = 64 if small else 512
    spp = 32 if small else 250

    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96, name="sRGB")
    sampler = RGBAdaptiveSampler2D(rgb, ratio=10, fraction=0.2,
                                   min_samples=500, cutoff=0.01)
    camera = PinholeCamera(
        (size, size), parent=world,
        transform=translate(0, 0, -3.3) * rotate(0, 0, 0), pipelines=[rgb],
    )
    camera.frame_sampler = sampler
    camera.spectral_rays = 1
    camera.spectral_bins = 15
    camera.pixel_samples = spp
    camera.ray_importance_sampling = True
    camera.ray_important_path_weight = 0.25
    camera.ray_max_depth = 500
    camera.ray_extinction_min_depth = 3
    camera.ray_extinction_prob = 0.01
    # measured alive fractions for THIS scene (glass, extinction 0.01):
    # 21% after 5 bounces, 4.4% after 9 -> 3x then 4x shrinks leave ample
    # headroom (see tracer/wavefront.py)
    camera.compact_schedule = ((5, 3), (4, 4))

    render_pass = 1
    max_passes = 2 if small else 10
    while not camera.render_complete and render_pass <= max_passes:
        print(f"Rendering pass {render_pass}...")
        camera.observe()
        rgb.save(f"cornell_box_pass_{render_pass}.png")
        render_pass += 1
    print("done")


if __name__ == "__main__":
    main()
