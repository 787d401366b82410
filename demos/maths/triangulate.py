"""Maths showcase: ear-clipping polygon triangulation.

Counterpart of the reference's demos/maths/triangulate.py — triangulate a
concave polygon and verify the triangles tile it exactly (area sum and
point-in-polygon agreement).

Run: JAX_PLATFORMS=cpu python demos/maths/triangulate.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from source_tpu.core.math import point_inside_polygon, triangulate2d


def tri_area(v):
    a, b, c = v
    return 0.5 * abs((b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1]))


def main():
    # concave star-like polygon
    poly = np.array([
        [0.0, 0.0], [4.0, 0.0], [4.0, 3.0], [2.0, 1.5], [0.0, 3.0],
    ])
    tris = np.asarray(triangulate2d(poly))
    areas = [tri_area(poly[t]) for t in tris]
    # shoelace area of the polygon
    x, y = poly[:, 0], poly[:, 1]
    shoelace = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    print(f"{len(tris)} triangles, total area = {sum(areas):.4f} "
          f"(polygon shoelace area = {shoelace:.4f})")
    assert abs(sum(areas) - shoelace) < 1e-9

    # the notch point must be outside
    inside = bool(np.asarray(point_inside_polygon(poly, 2.0, 2.5)))
    print(f"point (2.0, 2.5) in notch: inside = {inside} (-> False)")
    assert not inside


if __name__ == "__main__":
    main()
