"""Per-scene benchmark suite (BASELINE.md measurement protocol).

Runs the demo scenes through the real observer pipeline and records the
canonical throughput statistic (rays/s, the reference's unit printed by
optical/observer/base/observer.pyx:500-511) for each. Each scene is
observed twice: the first pass compiles the wavefront kernels, the second
pass is the timed measurement (the reference's statistic likewise excludes
module import/compile cost — it times the render loop only).

Usage:  python benchmarks/suite.py [scene ...]
        (default: all scenes)

Prints one JSON line per scene, naming the device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


REPEATS = 9


def _observe_timed(camera):
    """Median rays/s over REPEATS timed passes after one compile + warm
    pass, with the spread (max - min) / median of those passes. Reference
    statistic being mimicked: optical/observer/base/observer.pyx:500-511."""
    camera.quiet = True
    camera.observe(seed=1)  # compile + warm pass
    rates = []
    for seed in range(2, 2 + REPEATS):
        for p in camera.pipelines:
            if hasattr(p, "accumulate"):
                p.accumulate = False  # reset stats so each timed pass is clean
        camera.observe(seed=seed)
        rates.append(camera.rays_per_second)
    rates.sort()
    median = rates[len(rates) // 2]
    return median, (rates[-1] - rates[0]) / median


def bench_cornell():
    from demos.cornell_box import build_world
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D
    from source_tpu.core import translate

    world = build_world(glass=False)
    rgb = RGBPipeline2D()
    camera = PinholeCamera((256, 256), fov=45, parent=world,
                           transform=translate(0, 0, -3.3), pipelines=[rgb])
    camera.pixel_samples = 64
    camera.spectral_bins = 15
    camera.ray_max_depth = 16
    camera.max_wavefront_iters = 24
    camera.compact_schedule = ((3, 4), (3, 4))
    return _observe_timed(camera)


def bench_prism():
    from demos.prism import build_world
    from source_tpu.core import rotate, translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    world = build_world()
    rgb = RGBPipeline2D()
    camera = PinholeCamera(
        (256, 144), fov=45, parent=world,
        transform=translate(0, 0.075, -0.05) * rotate(180, -45, 0)
        * translate(0, 0, -0.75),
        pipelines=[rgb],
    )
    camera.pixel_samples = 32
    camera.spectral_bins = 16
    camera.spectral_rays = 4  # dispersion slicing (4 slices keeps compile cost sane)
    camera.ray_importance_sampling = True
    camera.ray_important_path_weight = 0.75
    camera.ray_max_depth = 32
    camera.max_wavefront_iters = 40
    return _observe_timed(camera)


def bench_csg():
    from demos.csg import build_world
    from source_tpu.core import translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    world = build_world()
    rgb = RGBPipeline2D()
    camera = PinholeCamera((256, 256), fov=75, parent=world,
                           transform=translate(0, 0, -4), pipelines=[rgb])
    camera.pixel_samples = 64
    camera.spectral_bins = 15
    camera.ray_max_depth = 24
    camera.max_wavefront_iters = 32
    camera.compact_schedule = ((4, 4), (4, 4))
    return _observe_timed(camera)


def bench_mis():
    from demos.multiple_importance_sampling import build_world
    from source_tpu.core import rotate, translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    world = build_world()
    rgb = RGBPipeline2D()
    camera = PinholeCamera((256, 192), fov=45, parent=world,
                           transform=translate(0, 1.2, -3.5) * rotate(0, -5, 0),
                           pipelines=[rgb])
    camera.pixel_samples = 64
    camera.spectral_bins = 12
    camera.ray_importance_sampling = True
    camera.ray_important_path_weight = 0.3
    camera.ray_max_depth = 12
    camera.max_wavefront_iters = 16
    camera.compact_schedule = ((3, 4), (3, 4))
    return _observe_timed(camera)


def bench_mesh():
    from demos.mesh_render import build_world
    from source_tpu.core import rotate, translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    world = build_world(small=True)
    rgb = RGBPipeline2D()
    camera = PinholeCamera((192, 192), fov=45, parent=world,
                           transform=translate(0, 1.0, -4.5) * rotate(0, -8, 0),
                           pipelines=[rgb])
    camera.pixel_samples = 32
    camera.spectral_bins = 12
    camera.ray_max_depth = 12
    camera.max_wavefront_iters = 16
    # the open scene kills most lanes within 2 bounces, and the dense
    # all-pairs mesh intersect pays per LANE x TRIANGLE whether lanes are
    # alive or not, so compaction starts early (dev/mesh_sched_ab.py A/Bs
    # schedules; not measured on the H100 yet)
    camera.compact_schedule = ((2, 8), (3, 4))
    return _observe_timed(camera)


SCENES = {
    "cornell": bench_cornell,
    "prism": bench_prism,
    "csg": bench_csg,
    "mis": bench_mis,
    "mesh": bench_mesh,
}


def main():
    import jax

    from source_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    wanted = [a for a in sys.argv[1:] if not a.startswith("-")] or list(SCENES)
    for name in wanted:
        t0 = time.time()
        rays_s, spread = SCENES[name]()
        print(json.dumps({
            "metric": f"{name}_fwd", "value": round(rays_s, 1),
            "unit": "rays/s/chip", "spread_pct": round(100.0 * spread, 1),
            "repeats": REPEATS, "device_kind": dev.device_kind,
            "wall_s": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
