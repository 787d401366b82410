"""Animation demo — source_tpu counterpart of the reference's
demos/animation.py: a rotating CSG glass solid re-rendered frame by frame
(scenegraph transform mutation -> lazy scene recompile per frame; the
wavefront kernels recompile only when scene STRUCTURE changes, so rotating
a transform re-uses the compiled render and only re-uploads the pytree).

Run: JAX_PLATFORMS=cpu python demos/animation.py --small
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Checkerboard
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Cylinder, Intersect, Sphere


def build_world():
    world = World()
    Box(Point3D(-10, -10, 4.0), Point3D(10, 10, 4.1), parent=world,
        material=Checkerboard(1, d65_white, d65_white, 0.2, 0.8))
    cube = Box(Point3D(-1.5, -1.5, -1.5), Point3D(1.5, 1.5, 1.5))
    sphere = Sphere(2.0)
    target = Intersect(sphere, cube, parent=world, material=schott("N-BK7"))
    return world, target


def main():
    small = "--small" in sys.argv
    world, target = build_world()
    rgb = RGBPipeline2D(accumulate=False)
    camera = PinholeCamera((48, 48) if small else (256, 256), fov=45,
                           parent=world, transform=translate(0, 0, -6),
                           pipelines=[rgb])
    camera.spectral_rays = 3 if small else 9
    camera.spectral_bins = 30
    camera.pixel_samples = 4 if small else 64
    camera.ray_max_depth = 16 if small else 100
    camera.quiet = True

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results", "animation")
    os.makedirs(out_dir, exist_ok=True)
    num_frames = 3 if small else 100
    for frame in range(num_frames):
        t0 = time.time()
        rotation = 360.0 / num_frames * frame
        target.transform = rotate(rotation, 25, 5)
        camera.observe(seed=frame)
        rgb.save(os.path.join(out_dir, f"frame{frame:04}.png"))
        print(f"frame {frame}: {time.time() - t0:0.2f}s", flush=True)


if __name__ == "__main__":
    main()
