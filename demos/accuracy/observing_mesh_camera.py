"""Accuracy harness: MeshCamera (per-triangle observer) on an inward box.

Counterpart of the reference's demos/accuracy/observing_mesh_camera.py:
each of the cube's 12 triangles is one pixel of a MeshCamera; the summed
per-triangle powers must equal the enclosed sphere's total emission
(same closed forms as observing_mesh_pixel.py), and symmetry makes all
per-face powers equal.

Run: JAX_PLATFORMS=cpu python demos/accuracy/observing_mesh_camera.py
"""

import math
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))

import numpy as np

from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import UniformSurfaceEmitter
from source_tpu.optical.observer import MeshCamera, PowerPipeline1D
from source_tpu.primitive import Sphere

from observing_mesh_pixel import box_mesh_inwards


def main():
    sphere_radius = 0.5
    world = World()
    Sphere(radius=sphere_radius, parent=world,
           material=UniformSurfaceEmitter(ConstantSF(1.0)))

    mesh = box_mesh_inwards(2.0)
    power = PowerPipeline1D(accumulate=False)
    camera = MeshCamera(mesh, pipelines=[power], parent=world)
    camera.min_wavelength = 400.0
    camera.max_wavelength = 401.0
    camera.spectral_bins = 1
    camera.pixel_samples = 20_000
    camera.ray_extinction_prob = 0.0
    camera.quiet = True
    camera.observe(seed=5)

    per_tri = np.asarray(power.frame.mean)
    total = float(per_tri.sum())
    theory = 4.0 * math.pi ** 2 * sphere_radius ** 2
    err = abs(total - theory) / theory
    spread = float(per_tri.std() / per_tri.mean())
    print(f"Mesh camera: total = {total:.4f} W over {per_tri.shape[0]} triangles, "
          f"theory = {theory:.4f} W, relative error = {err:.2e}, "
          f"per-triangle spread = {spread:.2%}")
    assert err < 0.05
    assert spread < 0.05  # symmetry: every triangle sees the same power


if __name__ == "__main__":
    main()
