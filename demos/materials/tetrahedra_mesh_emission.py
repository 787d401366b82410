"""Tetrahedral-mesh volume emission — source_tpu counterpart of the
reference's demos/materials/tetrahedra_mesh_emission.py: an
InhomogeneousVolumeEmitter whose emission density is a Discrete3DMesh over
a tetrahedral mesh (per-tet constant data), ray-marched inside a bounding
box.

The reference loads a Stanford-bunny tet mesh (an external asset it does
not ship); here the tet mesh is generated procedurally — an icosphere
shell tetrahedralised against its centroid — exercising the identical
code path (Discrete3DMesh lookup inside the volume march).

Run: JAX_PLATFORMS=cpu python demos/materials/tetrahedra_mesh_emission.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core import Point3D, translate
from source_tpu.core.math.function import Discrete3DMesh
from source_tpu.core.scenegraph import World
from source_tpu.optical.library import RoughTitanium
from source_tpu.optical.material import InhomogeneousVolumeEmitter, NumericalIntegrator
from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
from source_tpu.primitive import Box


def icosphere_tets(subdiv=2, radius=0.5):
    """Tetrahedralise an icosphere: every surface triangle forms a tet with
    the centre; returns (vertices [N,3], tets [T,4])."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    for _ in range(subdiv):
        cache, new_faces = {}, []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int32)
    verts = verts * radius
    centre_idx = len(verts)
    verts = np.concatenate([verts, np.zeros((1, 3))])
    tets = np.concatenate([faces, np.full((len(faces), 1), centre_idx, np.int32)],
                          axis=1)
    return verts, tets


def build_world(subdiv=2):
    world = World()
    verts, tets = icosphere_tets(subdiv=subdiv, radius=0.5)
    # per-tet emission: brighter toward +y (per-tet constant data)
    centroids = verts[tets].mean(axis=1)
    tet_data = 1.0 + 4.0 * np.clip(centroids[:, 1] + 0.5, 0, 1)
    field = Discrete3DMesh(verts, tets, tet_data, limit=False, default_value=0.0)

    def emission(p, direction, wavelengths):
        import jax.numpy as jnp

        dens = field(p[..., 0], p[..., 1], p[..., 2])
        return jnp.broadcast_to(dens[..., None], dens.shape + (wavelengths.shape[0],))

    emitter = Box(Point3D(-0.6, -0.6, -0.6), Point3D(0.6, 0.6, 0.6),
                  parent=world, transform=translate(0, 0.62, 0),
                  material=InhomogeneousVolumeEmitter(
                      emission, integrator=NumericalIntegrator(max_samples=24)))
    Box(Point3D(-100, -0.1, -100), Point3D(100, -0.01, 100), parent=world,
        material=RoughTitanium(0.1))
    return world


def main():
    small = "--small" in sys.argv
    world = build_world(subdiv=1 if small else 2)
    rgb = RGBPipeline2D()
    camera = PinholeCamera((64, 64) if small else (512, 512), fov=50,
                           parent=world, transform=translate(0, 0.75, -2.2),
                           pipelines=[rgb])
    camera.spectral_bins = 4
    camera.pixel_samples = 8 if small else 200
    camera.ray_max_depth = 8 if small else 32
    camera.observe(seed=13)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "tetrahedra_mesh_emission.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
