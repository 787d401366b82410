"""A glass bunny on an illuminated glass pedestal — source_tpu counterpart
of the reference's demos/materials/bunny.py (its flagship mesh scene:
large mesh + N-BK7 dielectric + glass-walled volume-emitter light box).

The Stanford bunny asset is not shipped by the reference either (users
download it from the Stanford 3D scan repository). This demo uses
``demos/resources/stanford_bunny.ply`` if present; otherwise it GENERATES
a bunny-ish high-poly stand-in (a displaced icosphere, ~80k triangles at
full size), round-trips it through export_ply/import_ply, and renders the
same composition — exercising PLY IO, the large-mesh BVH path and the
dielectric together.

Run (GPU): python demos/materials/bunny.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/materials/bunny.py --small
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core import Point3D, rotate, translate
from source_tpu.core.scenegraph import Node, World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Lambert, UniformVolumeEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Subtract
from source_tpu.primitive.mesh import export_ply, import_ply

BUNNY_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "resources", "stanford_bunny.ply")


def _stand_in_mesh(subdiv):
    """Displaced icosphere ~0.1 m tall: a high-poly glass blob standing in
    for the bunny scan when the asset is absent."""
    from demos.mesh_render import icosphere  # local procedural generator

    v, f = icosphere(subdiv, radius=0.05)
    # low-frequency displacement for a scanned-organic look
    r = np.linalg.norm(v, axis=1, keepdims=True)
    n = v / r
    bump = (0.22 * np.sin(6.0 * n[:, 0]) * np.cos(4.0 * n[:, 1])
            + 0.15 * np.sin(5.0 * n[:, 2] + 1.7)) * 0.05
    v = v + n * bump[:, None] * 0.35
    v[:, 1] += 0.055  # rest on the pedestal
    return v, f


def build_world(small=False):
    world = World()

    if os.path.exists(BUNNY_PATH):
        import_ply(BUNNY_PATH, parent=world,
                   transform=rotate(165, 0, 0), material=schott("N-BK7"))
    else:
        v, f = _stand_in_mesh(3 if small else 5)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bunny_stand_in.ply")
            from source_tpu.primitive.mesh import Mesh

            export_ply(Mesh(v, f), path)
            import_ply(path, parent=world, material=schott("N-BK7"))

    # light box (reference bunny.py:40-70 composition)
    padding = 1e-5
    enclosure_thickness = 0.001 + padding
    glass_thickness = 0.003
    light_box = Node(parent=world)
    Subtract(
        Box(Point3D(-0.10 - enclosure_thickness, -0.02 - enclosure_thickness,
                    -0.10 - enclosure_thickness),
            Point3D(0.10 + enclosure_thickness, 0.0,
                    0.10 + enclosure_thickness)),
        Box(Point3D(-0.10 - padding, -0.02 - padding, -0.10 - padding),
            Point3D(0.10 + padding, 0.001, 0.10 + padding)),
        material=Lambert(ConstantSF(0.2)), parent=light_box)
    Subtract(
        Box(Point3D(-0.10, -0.02, -0.10), Point3D(0.10, 0.0, 0.10)),
        Box(Point3D(-0.10 + glass_thickness, -0.02 + glass_thickness,
                    -0.10 + glass_thickness),
            Point3D(0.10 - glass_thickness, -glass_thickness,
                    0.10 - glass_thickness)),
        material=schott("N-BK7"), parent=light_box)
    Box(Point3D(-0.10 + glass_thickness + padding,
                -0.02 + glass_thickness + padding,
                -0.10 + glass_thickness + padding),
        Point3D(0.10 - glass_thickness - padding,
                -glass_thickness - padding,
                0.10 - glass_thickness - padding),
        material=UniformVolumeEmitter(d65_white, 50), parent=light_box)
    return world


def main():
    small = "--small" in sys.argv
    world = build_world(small)
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96, name="sRGB")
    camera = PinholeCamera((48, 48) if small else (512, 512), parent=world,
                           transform=translate(0, 0.16, -0.4) * rotate(0, -12, 0),
                           pipelines=[rgb])
    camera.spectral_rays = 1 if small else 5
    camera.spectral_bins = 15
    camera.pixel_samples = 8 if small else 250
    camera.ray_max_depth = 16 if small else 500
    camera.max_wavefront_iters = 16 if small else 64
    camera.ray_extinction_prob = 0.01
    camera.observe(seed=8)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "bunny.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
