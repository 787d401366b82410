"""Ray-trajectory logging demo — counterpart of the reference's
demos/optics/logging_trajectories.py: traces LoggingRays through a
focusing lens and prints (or plots) the recorded path vertices.

Run: JAX_PLATFORMS=cpu python demos/optics/logging_trajectories.py
"""

import sys

sys.path.insert(0, ".")

from source_tpu.core import Point3D
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.loggingray import LoggingRay
from source_tpu.optical.material import AbsorbingSurface, Dielectric
from source_tpu.primitive import BiConvex, Box


def main():
    world = World()
    BiConvex(0.02, 0.006, 0.05, 0.05, parent=world,
             material=Dielectric(ConstantSF(1.5), ConstantSF(1.0),
                                 transmission_only=True))
    # screen past the focal plane
    Box(Point3D(-0.05, -0.05, 0.062), Point3D(0.05, 0.05, 0.063),
        parent=world, material=AbsorbingSurface())

    print("ray trajectories through an f~51mm biconvex lens:")
    for h in (-0.008, -0.004, 0.0, 0.004, 0.008):
        ray = LoggingRay(origin=(h, 0.0, -0.05), direction=(0, 0, 1),
                         bins=4, max_depth=8)
        ray.trace(world)
        pts = " -> ".join(f"({v[0]*1e3:+.2f}, {v[2]*1e3:+.2f})mm"
                          for v in ray.path_vertices)
        print(f"  h={h*1e3:+.1f}mm: {pts}")
        # full per-vertex records (reference loggingray.pyx Intersections)
        recs = " ".join(
            f"[mat={r['material']} exit={int(r['exiting'])}"
            f" nz={r['normal'][2]:+.2f}]"
            for r in ray.path_intersections
        )
        print(f"           {recs}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 4))
        for h in [i * 1e-3 for i in range(-8, 9, 2)]:
            ray = LoggingRay(origin=(h, 0.0, -0.05), direction=(0, 0, 1),
                             bins=4, max_depth=8)
            ray.trace(world)
            xs = [v[2] for v in ray.path_vertices]
            ys = [v[0] for v in ray.path_vertices]
            plt.plot(xs, ys, "-o", markersize=2)
        plt.xlabel("z [m]")
        plt.ylabel("x [m]")
        plt.title("LoggingRay trajectories through a biconvex lens")
        plt.savefig("logging_trajectories.png", dpi=120)
        print("saved logging_trajectories.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
