"""Accuracy harness: optical fibre viewing a small emitting sphere.

Counterpart of the reference's demos/accuracy/observing_fibre.py: a
FibreOptic whose acceptance cone fully contains a distant unity emitter
sphere must measure the sphere's total emission scaled by the fibre's
view fraction. Closed forms:

  volume emitter:  P_total = 16/3 * pi^2 * r^3 * d_lambda
  surface emitter: P_total = 4 * pi^2 * r^2 * d_lambda

with view fraction ~ (pi * rf^2) / (4 * pi * D^2) for fibre radius rf at
distance D (valid for rf, r << D).

Run: JAX_PLATFORMS=cpu python demos/accuracy/observing_fibre.py
"""

import math
import sys

sys.path.insert(0, ".")

from source_tpu.core import translate
from source_tpu.core.scenegraph import World
from source_tpu.optical.material import UniformVolumeEmitter, UniformSurfaceEmitter
from source_tpu.optical import ConstantSF
from source_tpu.optical.observer import FibreOptic, PowerPipeline0D
from source_tpu.primitive import Sphere


def main():
    sphere_radius = 0.5
    fibre_distance = 25.0
    fibre_radius = 0.005
    fibre_half_angle = 10.0  # degrees — cone sees the whole sphere

    world = World()
    emitter = Sphere(radius=sphere_radius, parent=world,
                     material=UniformVolumeEmitter(ConstantSF(1.0)))

    power = PowerPipeline0D(accumulate=False)
    fibre = FibreOptic(acceptance_angle=fibre_half_angle, radius=fibre_radius,
                       pipelines=[power], parent=world,
                       transform=translate(0, 0, -fibre_distance))
    fibre.min_wavelength = 400.0
    fibre.max_wavelength = 401.0
    fibre.spectral_bins = 1
    fibre.pixel_samples = 200_000
    fibre.ray_extinction_prob = 0.0
    fibre.quiet = True

    d_lambda = fibre.max_wavelength - fibre.min_wavelength
    view_fraction = (math.pi * fibre_radius ** 2) / (4 * math.pi * fibre_distance ** 2)

    fibre.observe(seed=11)
    theory_v = 16.0 / 3.0 * math.pi ** 2 * sphere_radius ** 3 * d_lambda
    measured_v = power.value.mean / view_fraction
    err_v = abs(measured_v - theory_v) / theory_v
    print(f"Volume emitter:  measured = {measured_v:.4f} W, "
          f"theory = {theory_v:.4f} W, relative error = {err_v:.2e}")

    emitter.material = UniformSurfaceEmitter(ConstantSF(1.0))
    power2 = PowerPipeline0D(accumulate=False)
    fibre.pipelines = [power2]
    fibre.observe(seed=12)
    theory_s = 4.0 * math.pi ** 2 * sphere_radius ** 2 * d_lambda
    measured_s = power2.value.mean / view_fraction
    err_s = abs(measured_s - theory_s) / theory_s
    print(f"Surface emitter: measured = {measured_s:.4f} W, "
          f"theory = {theory_s:.4f} W, relative error = {err_s:.2e}")
    assert err_v < 0.05 and err_s < 0.05


if __name__ == "__main__":
    main()
