"""Observer showcase: orthographic (parallel projection) camera.

Counterpart of the reference's demos/observers/orthographic.py — the CSG
demo scene viewed through an OrthographicCamera; parallel rays keep the
solids' silhouettes undistorted.

Run (GPU): python demos/observers/orthographic.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/observers/orthographic.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import time

from demos.csg import build_world
from source_tpu.core import translate
from source_tpu.optical.observer import OrthographicCamera, RGBPipeline2D


def main():
    small = "--small" in sys.argv
    world = build_world()
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.98)
    camera = OrthographicCamera(
        (64, 64) if small else (384, 384), width=4.0, parent=world,
        transform=translate(0, 0, -4), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 100
    camera.ray_max_depth = 12 if small else 40
    camera.max_wavefront_iters = 16 if small else 48

    t0 = time.time()
    camera.observe(seed=31)
    print(f"orthographic demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("orthographic_render.png")


if __name__ == "__main__":
    main()
