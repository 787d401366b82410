"""Observer showcase: per-triangle power map over a mesh surface.

Counterpart of the reference's demos/observers/mesh_power.py — a
MeshCamera on an icosphere beside a bright panel; the per-triangle power
falls off with the cosine of the angle to the panel, so the lit hemisphere
collects nearly all the power.

Run: JAX_PLATFORMS=cpu python demos/observers/mesh_power.py
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))

import numpy as np

from demos.mesh_render import icosphere
from source_tpu.core import Point3D, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import UniformSurfaceEmitter
from source_tpu.optical.observer import MeshCamera, PowerPipeline1D
from source_tpu.primitive import Box
from source_tpu.primitive.mesh import MeshData


def main():
    world = World()
    # bright panel on the +x side
    Box(Point3D(2, -1.5, -1.5), Point3D(2.2, 1.5, 1.5), parent=world,
        material=UniformSurfaceEmitter(ConstantSF(1.0), 10.0))

    verts, tris = icosphere(subdivisions=2, radius=0.5)
    mesh = MeshData(verts, tris, smoothing=False)
    power = PowerPipeline1D(accumulate=False)
    camera = MeshCamera(mesh, pipelines=[power], parent=world)
    camera.pixel_samples = 2000
    camera.quiet = True
    camera.observe(seed=43)

    per_tri = np.asarray(power.frame.mean)
    centroids = verts[tris].mean(axis=1)
    lit = centroids[:, 0] > 0.0
    frac = per_tri[lit].sum() / max(per_tri.sum(), 1e-30)
    print(f"{per_tri.shape[0]} triangles observed; "
          f"+x hemisphere (x>0) collects {frac:.1%} of total power "
          f"(total {per_tri.sum():.3e} W)")
    assert frac > 0.7


if __name__ == "__main__":
    main()
