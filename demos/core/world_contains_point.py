"""Core API showcase: point containment queries against the scenegraph.

Counterpart of the reference's demos/core/world_contains_point.py — probe
World.contains() over a grid of points straddling a CSG solid and report
the enclosed volume fraction against the closed form.

Run: JAX_PLATFORMS=cpu python demos/core/world_contains_point.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core import Point3D
from source_tpu.core.scenegraph import World
from source_tpu.optical.material import AbsorbingSurface
from source_tpu.primitive import Sphere


def main():
    world = World()
    Sphere(0.5, parent=world, material=AbsorbingSurface())

    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.6, 0.6, size=(20000, 3))
    inside = np.fromiter(
        (len(world.contains(Point3D(*p))) > 0 for p in pts), bool, len(pts)
    )
    measured = inside.mean() * 1.2 ** 3
    theory = 4.0 / 3.0 * math.pi * 0.5 ** 3
    err = abs(measured - theory) / theory
    print(f"Monte-Carlo sphere volume: measured = {measured:.4f}, "
          f"theory = {theory:.4f}, relative error = {err:.2e}")
    assert err < 0.05


if __name__ == "__main__":
    main()
