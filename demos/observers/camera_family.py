"""Observer showcase: CCDArray, VectorCamera and OpenCVCamera.

Counterparts of the reference's demos/observers/{cornell_box_real_pinhole,
...}.py camera-variant demos — render the same simple scene through the
physically modelled CCD, a calibrated per-pixel VectorCamera and an
OpenCV-matrix camera and report per-camera mean signal.

Run (GPU): python demos/observers/camera_family.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/observers/camera_family.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core import Point3D, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white
from source_tpu.optical.material import Lambert, UniformSurfaceEmitter
from source_tpu.optical.observer import (
    CCDArray, OpenCVCamera, RGBPipeline2D, VectorCamera,
)
from source_tpu.primitive import Box, Sphere


def build_world():
    world = World()
    # emitter panel visible around the sphere (sphere angular radius ~14 deg)
    Box(Point3D(-5, -5, 4), Point3D(5, 5, 4.2), parent=world,
        material=UniformSurfaceEmitter(d65_white, 1.5))
    Sphere(0.5, parent=world, transform=translate(0, 0, 2.0),
           material=Lambert(ConstantSF(0.6)))
    return world


def mean_signal(pipeline):
    return float(np.asarray(pipeline.xyz_frame.mean).mean())


def main():
    small = "--small" in sys.argv
    nx, ny = (32, 24) if small else (192, 144)
    spp = 4 if small else 32
    world = build_world()

    results = {}

    rgb = RGBPipeline2D()
    ccd = CCDArray(pixels=(nx, ny), width=0.035, pipelines=[rgb], parent=world)
    ccd.pixel_samples = spp
    ccd.ray_max_depth = 6
    ccd.max_wavefront_iters = 8
    ccd.quiet = True
    ccd.observe(seed=61)
    results["CCDArray"] = mean_signal(rgb)

    # calibrated per-pixel rays reproducing a pinhole view
    xs = np.linspace(-0.3, 0.3, nx)
    ys = np.linspace(-0.225, 0.225, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    dirs = np.stack([gx, gy, np.ones((nx, ny))], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros_like(dirs)
    rgb_v = RGBPipeline2D()
    vec = VectorCamera(origins, dirs, pipelines=[rgb_v], parent=world)
    vec.pixel_samples = spp
    vec.ray_max_depth = 6
    vec.max_wavefront_iters = 8
    vec.quiet = True
    vec.observe(seed=62)
    results["VectorCamera"] = mean_signal(rgb_v)

    fx = fy = nx  # ~53 deg horizontal fov
    cam_matrix = [[fx, 0, nx / 2], [0, fy, ny / 2], [0, 0, 1]]
    rgb_cv = RGBPipeline2D()
    cv = OpenCVCamera(cam_matrix, distortion=[0.05, 0.0, 0.0, 0.0, 0.0],
                      pixels=(nx, ny), pipelines=[rgb_cv], parent=world)
    cv.pixel_samples = spp
    cv.ray_max_depth = 6
    cv.max_wavefront_iters = 8
    cv.quiet = True
    cv.observe(seed=63)
    results["OpenCVCamera"] = mean_signal(rgb_cv)

    for name, val in results.items():
        print(f"{name:14s} mean XYZ signal = {val:.3e}")
        assert val > 0.0
    rgb_cv.save("camera_family_render.png")


if __name__ == "__main__":
    main()
