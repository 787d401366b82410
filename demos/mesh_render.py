"""Triangle-mesh demo — stands in for the reference's mesh demos
(demos/materials/bunny.py, demos/raysect_logo.py, which ship binary mesh
assets). Builds procedural meshes — a subdivided icosphere and a torus
knot tube — and renders them with metal and glass materials through the
BVH traversal path.

Run (GPU): python demos/mesh_render.py
Fast CPU smoke: JAX_PLATFORMS=cpu python demos/mesh_render.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

import numpy as np

from source_tpu.core import Point3D, translate, rotate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.library import d65_white, schott
from source_tpu.optical.material import Lambert, RoughConductor, UniformSurfaceEmitter
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box, Mesh


def icosphere(subdivisions=3, radius=1.0):
    """Subdivided icosahedron: vertices [V,3], triangles [T,3]."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def torus_knot(p=2, q=3, tube=0.25, scale=0.6, segments=160, sides=12):
    """Tube swept along a (p,q) torus knot: vertices + triangles."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = 2.0 + np.cos(q * t)
    centre = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1
    ) * scale
    # frames along the curve
    tangent = np.roll(centre, -1, axis=0) - np.roll(centre, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    normal = np.cross(tangent, ref)
    bad = np.linalg.norm(normal, axis=1) < 1e-6
    normal[bad] = np.cross(tangent[bad], [1.0, 0.0, 0.0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    binormal = np.cross(tangent, normal)

    phi = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * normal[None] +
            np.sin(phi)[:, None, None] * binormal[None])  # [sides, seg, 3]
    verts = (centre[None] + tube * scale * ring).transpose(1, 0, 2).reshape(-1, 3)

    tris = []
    for i in range(segments):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            c = ((i + 1) % segments) * sides + j
            d = ((i + 1) % segments) * sides + (j + 1) % sides
            tris += [[a, c, b], [b, c, d]]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def build_world(small=False):
    world = World()

    v, f = icosphere(2 if small else 3, radius=0.8)
    Mesh(v, f, smoothing=True, closed=True, parent=world,
         transform=translate(-1.1, 0.8, 0.0),
         material=schott("N-BK7"))

    v2, f2 = torus_knot(segments=64 if small else 160, sides=8 if small else 12)
    Mesh(v2, f2, smoothing=True, closed=True, parent=world,
         transform=translate(1.2, 0.9, 0.3) * rotate(0, 70, 0),
         material=RoughConductor(ConstantSF(0.9), ConstantSF(6.0), 0.2))

    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.6)))
    Box(Point3D(-10, 0, 4), Point3D(10, 6, 4.1), parent=world,
        material=Lambert(ConstantSF(0.3)))
    Box(Point3D(-1.5, 3.0, -1.5), Point3D(1.5, 3.2, 1.5), parent=world,
        material=UniformSurfaceEmitter(d65_white, 4.0))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world(small)
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.97)
    camera = PinholeCamera(
        (64, 48) if small else (512, 384), fov=50, parent=world,
        transform=translate(0, 1.4, -3.6) * rotate(0, -8, 0), pipelines=[rgb],
    )
    camera.pixel_samples = 8 if small else 150
    camera.spectral_bins = 12
    camera.ray_max_depth = 12 if small else 40
    camera.max_wavefront_iters = 16 if small else 48

    t0 = time.time()
    camera.observe(seed=5)
    print(f"mesh demo rendered in {time.time() - t0:0.1f}s")
    rgb.save("mesh_render.png")


if __name__ == "__main__":
    main()
