"""Observer showcase: TargetedPixel vs plain Pixel variance.

Counterpart of the reference's demos/observers/targeted_pixel.py — a
small bright emitter far from the observer: a TargetedPixel aimed at the
emitter's bounding sphere reaches the same mean power as a plain Pixel
with far less variance at equal sample count.

Run: JAX_PLATFORMS=cpu python demos/observers/targeted_pixel.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from source_tpu.core import translate
from source_tpu.core.scenegraph import World
from source_tpu.optical import ConstantSF
from source_tpu.optical.material import UniformSurfaceEmitter
from source_tpu.optical.observer import Pixel, PowerPipeline0D, TargetedPixel
from source_tpu.primitive import Sphere


def main():
    world = World()
    target = Sphere(0.05, parent=world, transform=translate(0, 0, 4),
                    material=UniformSurfaceEmitter(ConstantSF(1.0), 100.0))

    samples = 50_000
    plain_pipe = PowerPipeline0D(accumulate=False)
    plain = Pixel(x_width=0.01, y_width=0.01, pipelines=[plain_pipe], parent=world)
    plain.pixel_samples = samples
    plain.quiet = True
    plain.observe(seed=41)

    targ_pipe = PowerPipeline0D(accumulate=False)
    targeted = TargetedPixel(target, x_width=0.01, y_width=0.01,
                             targeted_path_prob=0.95, pipelines=[targ_pipe],
                             parent=world)
    targeted.pixel_samples = samples
    targeted.quiet = True
    targeted.observe(seed=42)

    print(f"plain pixel:    {plain_pipe.value.mean:.3e} +/- {plain_pipe.value.error():.1e} W")
    print(f"targeted pixel: {targ_pipe.value.mean:.3e} +/- {targ_pipe.value.error():.1e} W")
    ratio = plain_pipe.value.error() / max(targ_pipe.value.error(), 1e-30)
    print(f"error reduction: {ratio:.1f}x at equal samples")
    assert ratio > 2.0


if __name__ == "__main__":
    main()
