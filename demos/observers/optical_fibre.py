"""Optical fibre observation — source_tpu counterpart of the reference's
demos/observers/optical_fibre.py: a FibreOptic views a glass sphere in
front of a checkerboard emitter and records power/radiance and full
spectral pipelines in one observation.

Run: JAX_PLATFORMS=cpu python demos/observers/optical_fibre.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Checkerboard, Lambert
from source_tpu.optical.observer import (
    FibreOptic,
    PowerPipeline0D,
    RadiancePipeline0D,
    SpectralPowerPipeline0D,
    SpectralRadiancePipeline0D,
)
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    Box(Point3D(-50, -1.51, -50), Point3D(50, -1.5, 50), parent=world,
        material=Lambert(ConstantSF(0.5)))
    Box(Point3D(-10, -10, 10), Point3D(10, 10, 10.1), parent=world,
        transform=rotate(45, 0, 0),
        material=Checkerboard(4, d65_white, d65_white, 0.1, 2.0))
    Sphere(radius=1.5, parent=world, transform=translate(0, 0.0001, 0),
           material=schott("N-BK7"))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    spectral_power = SpectralPowerPipeline0D()
    spectral_radiance = SpectralRadiancePipeline0D()
    power = PowerPipeline0D()
    radiance = RadiancePipeline0D()
    fibre = FibreOptic(acceptance_angle=10, radius=0.0005, parent=world,
                       transform=translate(0, 0, -5),
                       pipelines=[spectral_power, spectral_radiance,
                                  power, radiance])
    fibre.spectral_bins = 32 if small else 500
    fibre.pixel_samples = 256 if small else 100_000
    fibre.samples_per_task = 256 if small else 10_000  # streaming chunks
    fibre.ray_max_depth = 16 if small else 100
    fibre.observe(seed=3)
    print(f"power     = {power.value.mean:.4e} +/- {power.value.error():.1e} W")
    print(f"radiance  = {radiance.value.mean:.4e} W/m2/sr")
    print(f"spectral pipeline bins: {spectral_power.frame.mean.shape}")


if __name__ == "__main__":
    main()
