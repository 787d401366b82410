"""Host-side PixelProcessor cost measurement (VERDICT r3 weak #6).

The reference drives EVERY pipeline through per-pixel PixelProcessor
objects (base/observer.pyx:363-419); here only user pipelines written
against that compatibility API take the host path — built-ins fold
statistics on device. This benchmark renders one scene twice (device
RGB pipeline vs a custom PixelProcessor pipeline) and records the
host-path overhead so the claim in BASELINE.md is measured, not
asserted. Runs on the CPU or the GPU; the RATIO is the tracked quantity.

Usage: python benchmarks/pixelproc.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from demos.cornell_box import build_world
    from source_tpu.core import translate
    from source_tpu.optical.observer import (
        PinholeCamera, PixelProcessor, Pipeline2D, RGBPipeline2D,
    )
    from source_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    class _MeanProcessor(PixelProcessor):
        def __init__(self):
            self.total = 0.0
            self.n = 0

        def add_sample(self, spectrum, sensitivity):
            self.total += float(spectrum.samples.mean()) * sensitivity
            self.n += 1

        def pack_results(self):
            return self.total, self.n

    class MeanPipeline(Pipeline2D):
        def initialise(self, shape, spectral_config, slices, quiet=False):
            self.frame = np.zeros(shape)

        def pixel_processor(self, pixel, slice_id):
            return _MeanProcessor()

        def update(self, pixel, packed, slice_id):
            total, n = packed
            self.frame[np.unravel_index(pixel, self.frame.shape)] += total / max(n, 1)

        def finalise(self):
            pass

    size, spp = 48, 128
    world = build_world(glass=False)

    def run(pipes):
        cam = PinholeCamera((size, size), parent=world, pipelines=pipes,
                            transform=translate(0, 0, -3.3))
        cam.pixel_samples = spp
        cam.spectral_bins = 12
        cam.quiet = True
        cam.observe(seed=1)  # compile
        t0 = time.perf_counter()
        cam.observe(seed=2)
        return time.perf_counter() - t0

    t_dev = run([RGBPipeline2D()])
    t_proc = run([MeanPipeline()])
    t_both = run([RGBPipeline2D(), MeanPipeline()])
    res = {
        "pixels": size * size, "spp": spp,
        "device_pipeline_s": round(t_dev, 3),
        "pixelprocessor_pipeline_s": round(t_proc, 3),
        "both_s": round(t_both, 3),
        "host_path_overhead_x": round(t_proc / t_dev, 2),
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
