"""Etendue validation — counterpart of demos/optics/etendue_of_pinhole.py:
measure the power collected by a small Pixel behind a pinhole aperture and
compare with the analytic etendue-limited value.

A pixel of area A_p at distance d behind a pinhole of area A_h, looking at
a uniform radiance L field, collects P = L * A_p * A_h * cos^4(theta) / d^2
integrated over the hole — for an on-axis small hole this reduces to
P ~= L_int * A_p * Omega_hole where Omega_hole = A_h / d^2.

Run: JAX_PLATFORMS=cpu python demos/optics/etendue_of_pinhole.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from source_tpu.core import Point3D, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical.material import AbsorbingSurface, UnitySurfaceEmitter
from source_tpu.optical.observer import Pixel, PowerPipeline0D
from source_tpu.primitive import Box, Subtract, Sphere


def main():
    hole_radius = 0.005
    distance = 0.05
    pixel_w = 0.002

    world = World()
    Sphere(radius=5.0, parent=world, material=UnitySurfaceEmitter())

    # opaque plate with a square pinhole, at z = +distance from the pixel
    plate = Box(Point3D(-50, -50, 0.0), Point3D(50, 50, 0.001))
    hole = Box(Point3D(-hole_radius, -hole_radius, -0.001),
               Point3D(hole_radius, hole_radius, 0.002))
    aperture = Subtract(plate, hole)
    aperture.parent = world
    aperture.transform = translate(0, 0, distance)
    aperture.material = AbsorbingSurface()

    pipe = PowerPipeline0D(accumulate=False)
    pixel = Pixel(x_width=pixel_w, y_width=pixel_w, pipelines=[pipe],
                  parent=world)
    pixel.pixel_samples = 200000
    pixel.ray_extinction_prob = 0.0
    pixel.quiet = True
    pixel.observe(seed=5)

    d_lambda = pixel.max_wavelength - pixel.min_wavelength
    hole_area = (2 * hole_radius) ** 2
    omega = hole_area / distance ** 2
    theory = d_lambda * pixel.collection_area * omega
    measured = pipe.value.mean
    err = abs(measured - theory) / theory
    print(f"Pinhole etendue: measured = {measured:.3e} W, "
          f"paraxial theory = {theory:.3e} W, deviation = {err * 100:.1f}%")
    # paraxial formula is approximate (finite hole): expect a few percent
    assert err < 0.1


if __name__ == "__main__":
    main()
