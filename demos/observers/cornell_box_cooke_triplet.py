"""Cornell box imaged through a Cooke-triplet lens system — source_tpu
counterpart of the reference's demos/observers/cornell_box_cooke_triplet.py:
a Meniscus / BiConcave / BiConvex triplet (Arizona OPTI517 design) with
absorbing body, mounts and stop, imaged onto a TargetedCCDArray whose
targeted sampling aims at the stop aperture.

Run: JAX_PLATFORMS=cpu python demos/observers/cornell_box_cooke_triplet.py --small
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from demos.cornell_box import build_world
from source_tpu.core.scenegraph import Node
from source_tpu.core import rotate, translate
from source_tpu.optical.library import schott
from source_tpu.optical.material import AbsorbingSurface, NullMaterial
from source_tpu.optical.observer import RGBPipeline2D, TargetedCCDArray
from source_tpu.primitive import Cylinder, Subtract
from source_tpu.primitive.lens import BiConcave, BiConvex, Meniscus


def mm(v):
    return v * 1e-3


def build_camera(world):
    camera = Node(parent=world, transform=translate(0, 0, -3.8))

    lenses = Node(parent=camera)
    l1 = Meniscus(mm(21), mm(4.831), mm(23.713), mm(7331.288), parent=lenses,
                  transform=translate(0, 0, mm(-4.831)),
                  material=schott("N-LAK9"))
    l2 = BiConcave(mm(13), mm(0.975), mm(24.456), mm(21.896), parent=l1,
                   transform=translate(0, 0, mm(-6.835)),
                   material=schott("SF5"))
    l3 = BiConvex(mm(18), mm(3.127), mm(86.759), mm(20.4942), parent=l2,
                  transform=translate(0, 0, mm(-7.949)),
                  material=schott("N-LAK9"))
    image_plane = Node(parent=l3, transform=translate(0, 0, mm(-41.5)))

    # lens importance sampling off (the stop aperture is targeted instead)
    for lens in (l1, l2, l3):
        lens.material.importance = 0.0

    Subtract(Cylinder(mm(26), mm(80.0), transform=translate(0, 0, mm(-63))),
             Cylinder(mm(25), mm(79.1), transform=translate(0, 0, mm(-62))),
             parent=camera, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(5.0)),
             Cylinder(mm(21 / 2 + 0.01), mm(5.1), transform=translate(0, 0, mm(-0.05))),
             parent=l1, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(4.0)),
             Cylinder(mm(13 / 2 + 0.01), mm(4.1), transform=translate(0, 0, mm(-0.05))),
             parent=l2, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(1.0)),
             Cylinder(mm(12 / 2 + 0.01), mm(1.1), transform=translate(0, 0, mm(-0.05))),
             parent=l2, transform=translate(0, 0, mm(-2)),
             material=AbsorbingSurface())
    # null-material aperture target inside the stop
    aperture = Cylinder(mm(12 / 2), mm(0.5), parent=l2,
                        transform=translate(0, 0, mm(-1.95)),
                        material=NullMaterial())
    return image_plane, aperture


def main():
    small = "--small" in sys.argv
    world = build_world(glass=True)
    image_plane, aperture = build_camera(world)
    rgb = RGBPipeline2D(display_unsaturated_fraction=0.96, name="sRGB")
    ccd = TargetedCCDArray(targets=[aperture], parent=image_plane,
                           transform=rotate(0, 0, 180),
                           pipelines=[rgb],
                           pixels=(64, 64) if small else (360, 360),
                           width=mm(35))
    ccd.pixel_samples = 8 if small else 250
    ccd.spectral_bins = 12 if small else 15
    ccd.ray_max_depth = 24 if small else 500
    ccd.max_wavefront_iters = 24 if small else 64
    ccd.observe(seed=31)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "cornell_box_cooke_triplet.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    rgb.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
