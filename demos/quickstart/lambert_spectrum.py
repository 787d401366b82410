"""Quickstart: spectral measurement of light bounced off a Lambert wall.

Counterpart of the reference's demos/quickstart/lambert_spectrum.py — a
SightLine observer records the full per-bin spectrum of a D65 panel seen
via a diffuse bounce.

Run: JAX_PLATFORMS=cpu python demos/quickstart/lambert_spectrum.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import SightLine, SpectralRadiancePipeline0D
from source_tpu.primitive import Box


def main():
    world = World()
    # diffuse wall at z=2 facing the observer
    Box(Point3D(-5, -5, 2), Point3D(5, 5, 2.2), parent=world,
        material=Lambert(ConstantSF(0.8)))
    # D65 panel behind the observer lighting the wall
    Box(Point3D(-5, -5, -3.2), Point3D(5, 5, -3), parent=world,
        material=UniformSurfaceEmitter(d65_white, 2.0))

    spectrum = SpectralRadiancePipeline0D(accumulate=False)
    line = SightLine(pipelines=[spectrum], parent=world,
                     transform=rotate(0, 0, 0))
    line.min_wavelength = 380.0
    line.max_wavelength = 720.0
    line.spectral_bins = 64
    line.pixel_samples = 20_000
    line.quiet = True
    line.observe(seed=21)

    mean = np.asarray(spectrum.frame.mean).reshape(-1)
    wl = spectrum.wavelengths
    peak = wl[int(np.argmax(mean))]
    print(f"Spectrum observed over {len(wl)} bins: "
          f"mean radiance {mean.mean():.4f} W/m^2/sr/nm, peak bin at {peak:.0f} nm")
    assert mean.mean() > 0


if __name__ == "__main__":
    main()
