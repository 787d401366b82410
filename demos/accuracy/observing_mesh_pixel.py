"""Accuracy harness: MeshPixel observing from an inward-facing box.

Counterpart of the reference's demos/accuracy/observing_mesh_pixel.py: a
cube mesh with inward normals surrounds an emitting sphere; the MeshPixel
integrates power over the whole interior surface, so it must collect the
sphere's total emission. Closed forms (1 nm band):

  volume emitter:  P = 16/3 * pi^2 * r^3
  surface emitter: P = 4 * pi^2 * r^2

Run: JAX_PLATFORMS=cpu python demos/accuracy/observing_mesh_pixel.py
"""

import math
import sys

sys.path.insert(0, ".")

import numpy as np

from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import UniformSurfaceEmitter, UniformVolumeEmitter
from source_tpu.optical.observer import MeshPixel, PowerPipeline0D
from source_tpu.primitive import Sphere
from source_tpu.primitive.mesh import MeshData


def box_mesh_inwards(size=2.0):
    """Cube [-s/2, s/2]^3 as 12 triangles with inward-facing winding."""
    h = size / 2.0
    v = np.array([
        [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
        [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
    ], np.float64)
    # faces wound so geometric normals point toward the box centre
    quads = [
        (0, 1, 2, 3),  # z = -h, inward = +z
        (5, 4, 7, 6),  # z = +h, inward = -z
        (4, 0, 3, 7),  # x = -h, inward = +x
        (1, 5, 6, 2),  # x = +h, inward = -x
        (4, 5, 1, 0),  # y = -h, inward = +y
        (3, 2, 6, 7),  # y = +h, inward = -y
    ]
    tris = []
    for a, b, c, d in quads:
        tris += [(a, b, c), (a, c, d)]
    return MeshData(v, np.asarray(tris, np.int32), smoothing=False)


def main():
    sphere_radius = 0.5
    world = World()
    emitter = Sphere(radius=sphere_radius, parent=world,
                     material=UniformVolumeEmitter(ConstantSF(1.0)))

    mesh = box_mesh_inwards(2.0)
    power = PowerPipeline0D(accumulate=False)
    observer = MeshPixel(mesh, pipelines=[power], parent=world)
    observer.min_wavelength = 400.0
    observer.max_wavelength = 401.0
    observer.spectral_bins = 1
    observer.pixel_samples = 200_000
    observer.ray_extinction_prob = 0.0
    observer.quiet = True

    observer.observe(seed=3)
    theory_v = 16.0 / 3.0 * math.pi ** 2 * sphere_radius ** 3
    err_v = abs(power.value.mean - theory_v) / theory_v
    print(f"Volume emitter:  measured = {power.value.mean:.4f} W, "
          f"theory = {theory_v:.4f} W, relative error = {err_v:.2e}")

    emitter.material = UniformSurfaceEmitter(ConstantSF(1.0))
    power2 = PowerPipeline0D(accumulate=False)
    observer.pipelines = [power2]
    observer.observe(seed=4)
    theory_s = 4.0 * math.pi ** 2 * sphere_radius ** 2
    err_s = abs(power2.value.mean - theory_s) / theory_s
    print(f"Surface emitter: measured = {power2.value.mean:.4f} W, "
          f"theory = {theory_s:.4f} W, relative error = {err_s:.2e}")
    assert err_v < 0.05 and err_s < 0.05


if __name__ == "__main__":
    main()
