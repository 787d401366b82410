"""Materials showcase: anisotropic (cosine-power) surface emitter.

Counterpart of the reference's demos/materials/anisotropic_emitter.py —
plates with increasing cosine exponent viewed at a grazing angle: higher
exponents beam the emission toward the surface normal, so the plates dim
as the exponent grows.

Run (GPU): python demos/materials/anisotropic_emitter.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/anisotropic_emitter.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import AnisotropicSurfaceEmitter, Lambert
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box


def build_world():
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.25)))
    for i, power in enumerate([1.0, 4.0, 16.0, 64.0]):
        Box(Point3D(-0.4, 0.0, -0.4), Point3D(0.4, 0.02, 0.4), parent=world,
            transform=translate(-2.25 + i * 1.5, 0.02, 0),
            material=AnisotropicSurfaceEmitter(d65_white, 1.0, cosine_power=power))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = PinholeCamera(
        (96, 32) if small else (768, 256), fov=60, parent=world,
        transform=translate(0, 1.4, -3.6) * rotate(0, -18, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 80
    camera.ray_max_depth = 6 if small else 16
    camera.max_wavefront_iters = 8 if small else 20

    t0 = time.time()
    camera.observe(seed=14)
    print(f"anisotropic emitter demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("anisotropic_render.png")


if __name__ == "__main__":
    main()
