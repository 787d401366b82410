"""Modifier showcase: VolumeTransform offsetting a volume emission field.

Counterpart of the reference's demos/materials/modifiers/transform.py —
the same inhomogeneous striped glow rendered twice: raw, and wrapped in
VolumeTransform(rotate(0,0,45)) which rotates the stripes without touching
the primitive's geometry.

Run (GPU): python demos/materials/modifiers/volume_transform.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/modifiers/volume_transform.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))

import time

import jax.numpy as jnp

from source_tpu.core import Point3D, rotate_z, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import (
    InhomogeneousVolumeEmitter, Lambert, NumericalIntegrator, VolumeTransform,
)
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def striped_emission(p_local, d_local, wavelengths):
    """Vertical stripes in local x, warm spectrum. Returns [..., B]."""
    stripes = 4.0 * (0.5 + 0.5 * jnp.sin(12.0 * p_local[..., 0]))
    spectral = jnp.exp(-((wavelengths - 610.0) / 80.0) ** 2)
    return stripes[..., None] * spectral


def build_world():
    world = World()
    Box(Point3D(-10, -1.1, -10), Point3D(10, -1, 10), parent=world,
        material=Lambert(ConstantSF(0.3)))
    integ = NumericalIntegrator(max_samples=32)
    Sphere(0.8, parent=world, transform=translate(-1.0, 0, 0),
           material=InhomogeneousVolumeEmitter(striped_emission, integrator=integ))
    Sphere(0.8, parent=world, transform=translate(1.0, 0, 0),
           material=VolumeTransform(
               InhomogeneousVolumeEmitter(striped_emission, integrator=integ),
               rotate_z(45)))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.99)
    camera = PinholeCamera(
        (64, 32) if small else (512, 256), fov=55, parent=world,
        transform=translate(0, 0, -3.2), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 48
    camera.spectral_bins = 16
    camera.ray_max_depth = 6 if small else 12
    camera.max_wavefront_iters = 8 if small else 16

    t0 = time.time()
    camera.observe(seed=17)
    print(f"volume transform demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("volume_transform_render.png")


if __name__ == "__main__":
    main()
