"""Materials showcase: inhomogeneous glowing volume (spherical shell plume).

Counterpart of the reference's demos/materials/volume.py — an
InhomogeneousVolumeEmitter whose emission density is a smooth radial
Gaussian shell, ray-marched by the NumericalIntegrator inside a
transparent bounding sphere.

Run (GPU): python demos/materials/volume.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/volume.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

import jax.numpy as jnp

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import (
    InhomogeneousVolumeEmitter, Lambert, NumericalIntegrator,
)
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def shell_emission(p_local, d_local, wavelengths):
    """Gaussian shell at r=0.6, green-peaked spectrum. Returns [..., B]."""
    r = jnp.sqrt(jnp.sum(p_local * p_local, axis=-1) + 1e-12)
    density = 8.0 * jnp.exp(-((r - 0.6) / 0.12) ** 2)
    spectral = jnp.exp(-((wavelengths - 530.0) / 60.0) ** 2)
    return density[..., None] * spectral


def build_world():
    world = World()
    Box(Point3D(-10, -1.1, -10), Point3D(10, -1, 10), parent=world,
        material=Lambert(ConstantSF(0.3)))
    Sphere(1.0, parent=world, transform=translate(0, 0.2, 0),
           material=InhomogeneousVolumeEmitter(
               shell_emission, integrator=NumericalIntegrator(max_samples=48)))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.99)
    camera = PinholeCamera(
        (64, 64) if small else (384, 384), fov=45, parent=world,
        transform=translate(0, 0.4, -3.2) * rotate(0, -4, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 64
    camera.spectral_bins = 16
    camera.ray_max_depth = 6 if small else 16
    camera.max_wavefront_iters = 8 if small else 20

    t0 = time.time()
    camera.observe(seed=13)
    print(f"volume demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("volume_render.png")


if __name__ == "__main__":
    main()
