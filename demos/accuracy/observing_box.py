"""Accuracy harness: observer inside a unity-emitting box.

Counterpart of the reference's demos/accuracy/observing_box.py pattern.
Same closed form as the sphere (the enclosure shape is irrelevant for a
unity radiator): P = A * pi * d_lambda. Additionally checks a SightLine's
spectral radiance equals 1 exactly in every bin.

Run: JAX_PLATFORMS=cpu python demos/accuracy/observing_box.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from source_tpu.core import Point3D
from source_tpu.core.scenegraph import World
from source_tpu.optical.material import UnitySurfaceEmitter
from source_tpu.optical.observer import (
    Pixel, PowerPipeline0D, SightLine, SpectralRadiancePipeline0D,
)
from source_tpu.primitive import Box


def main():
    world = World()
    Box(Point3D(-5, -5, -5), Point3D(5, 5, 5), parent=world,
        material=UnitySurfaceEmitter())

    pipe = PowerPipeline0D(accumulate=False)
    pixel = Pixel(x_width=0.02, y_width=0.01, pipelines=[pipe], parent=world)
    pixel.pixel_samples = 5000
    pixel.ray_extinction_prob = 0.0
    pixel.quiet = True
    pixel.observe(seed=321)

    d_lambda = pixel.max_wavelength - pixel.min_wavelength
    theory = pixel.collection_area * np.pi * d_lambda
    measured = pipe.value.mean
    error = abs(measured - theory) / theory
    print(f"Observing box (Pixel): measured = {measured:.6f} W, "
          f"theory = {theory:.6f} W, relative error = {error:.2e}")
    assert error < 1e-3

    spec = SpectralRadiancePipeline0D(accumulate=False)
    line = SightLine(pipelines=[spec], parent=world)
    line.pixel_samples = 32
    line.ray_extinction_prob = 0.0
    line.quiet = True
    line.observe(seed=11)
    err = float(np.abs(np.asarray(spec.frame.mean) - 1.0).max())
    print(f"Observing box (SightLine): max |radiance - 1| = {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    main()
