"""Raysect logo demo — source_tpu counterpart of the reference's
demos/raysect_logo.py: six coloured-glass box "petals" arranged in a ring
inside a giant uniform-emitter sphere.

Run (GPU): python demos/raysect_logo.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/raysect_logo.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import Node, World
from source_tpu.optical import ConstantSF, InterpolatedSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Dielectric, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()

    wavelengths = np.array([300, 490, 510, 590, 610, 800])
    attns = {
        "red": np.array([0.0, 0.0, 0.0, 0.0, 1.0, 1.0]) * 0.98,
        "green": np.array([0.0, 0.0, 1.0, 1.0, 0.0, 0.0]) * 0.85,
        "blue": np.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]) * 0.98,
        "yellow": np.array([0.0, 0.0, 1.0, 1.0, 1.0, 1.0]) * 0.85,
        "cyan": np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0]) * 0.85,
        "purple": np.array([1.0, 1.0, 0.0, 0.0, 1.0, 1.0]) * 0.95,
    }
    glasses = {
        name: Dielectric(ConstantSF(1.4), InterpolatedSF(wavelengths, attn))
        for name, attn in attns.items()
    }

    Sphere(1000, parent=world, material=UniformSurfaceEmitter(d65_white, 1.0))

    node = Node(parent=world, transform=rotate(0, 0, 90))
    order = ["red", "yellow", "green", "cyan", "blue", "purple"]
    for i, name in enumerate(order):
        Box(Point3D(-0.5, 0, -2.5), Point3D(0.5, 0.25, 0.5), parent=node,
            transform=rotate(0, 0, 60 * i) * translate(0, 1, -0.500001),
            material=glasses[name])
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D()
    camera = PinholeCamera((64, 64) if small else (256, 256), fov=45,
                           parent=world, transform=translate(0, 0, -6.5),
                           pipelines=[rgb])
    camera.ray_max_depth = 32 if small else 100
    camera.max_wavefront_iters = 24 if small else 64
    camera.ray_extinction_prob = 0.01
    camera.pixel_samples = 16 if small else 100
    camera.spectral_bins = 21
    camera.observe(seed=42)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "raysect_logo.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
