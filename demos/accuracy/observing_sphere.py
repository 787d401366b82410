"""Accuracy harness: observer inside a unity-emitting sphere.

Counterpart of the reference's demos/accuracy/observing_sphere.py pattern:
build a scene whose answer is known in closed form and print measured vs
theoretical. A Pixel of area A inside a UnitySurfaceEmitter sphere must
measure P = A * pi * (lambda_max - lambda_min) watts.

Run: JAX_PLATFORMS=cpu python demos/accuracy/observing_sphere.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from source_tpu.core.scenegraph import World
from source_tpu.optical.material import UnitySurfaceEmitter
from source_tpu.optical.observer import Pixel, PowerPipeline0D
from source_tpu.primitive import Sphere


def main():
    world = World()
    Sphere(radius=10.0, parent=world, material=UnitySurfaceEmitter())

    pipe = PowerPipeline0D(accumulate=False)
    pixel = Pixel(x_width=0.01, y_width=0.01, pipelines=[pipe], parent=world)
    pixel.pixel_samples = 5000
    pixel.ray_extinction_prob = 0.0
    pixel.quiet = True
    pixel.observe(seed=123)

    d_lambda = pixel.max_wavelength - pixel.min_wavelength
    theory = pixel.collection_area * np.pi * d_lambda
    measured = pipe.value.mean
    error = abs(measured - theory) / theory
    print(f"Observing sphere: measured = {measured:.6f} W, "
          f"theory = {theory:.6f} W, relative error = {error:.2e}")
    assert error < 1e-3


if __name__ == "__main__":
    main()
