"""Core API showcase: host-side ray queries against the scenegraph.

Counterpart of the reference's demos/core/ray_intersection_hitpoints.py —
fire core Rays at a CSG solid with World.hit() and walk successive
surfaces by relaunching from each hit's outside point.

Run: JAX_PLATFORMS=cpu python demos/core/ray_intersection_hitpoints.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import Point3D, Ray, Vector3D, translate
from source_tpu.core.scenegraph import World
from source_tpu.optical.material import AbsorbingSurface
from source_tpu.primitive import Box, Sphere, Subtract


def main():
    world = World()
    solid = Subtract(
        Box(Point3D(-0.5, -0.5, -0.5), Point3D(0.5, 0.5, 0.5)),
        Sphere(0.6),
        parent=world, transform=translate(0, 0, 2),
        material=AbsorbingSurface(),
    )

    ray = Ray(Point3D(0.45, 0.45, -2), Vector3D(0, 0, 1))
    print(f"ray: origin {ray.origin}, direction {ray.direction}")
    hits = []
    while True:
        intersection = world.hit(ray)
        if intersection is None:
            break
        p = intersection.hit_point.transform(intersection.primitive_to_world)
        hits.append(p)
        print(f"  hit at z = {p.z:+.4f} (exiting={intersection.exiting})")
        ray = Ray(intersection.outside_point.transform(intersection.primitive_to_world)
                  if intersection.exiting else
                  intersection.inside_point.transform(intersection.primitive_to_world),
                  ray.direction)
    print(f"{len(hits)} surfaces crossed")
    assert len(hits) >= 2  # enters and exits the cut box corner


if __name__ == "__main__":
    main()
