"""THE shared flagship benchmark configuration.

bench.py (the headline), benchmarks/mfu.py (XLA cost-model rates) and
chip_smoke.py's train phase import scene, ray batch and RayConfig from here
so every number describes ONE program.

Protocol: Cornell box WITH the dielectric glass solids (refraction
roulette + Beer-Lambert volumes — the hard path), 512x512 pinhole rays,
15 spectral bins, max_depth 16, wavefront bound 24, NO stream compaction,
reverse-mode rematerialisation per bounce (REMAT_BLOCK=1).
"""

import sys

WIDTH = HEIGHT = 512
BINS = 15
MAX_DEPTH = 16
MAX_ITERS = 24
# The settings below were chosen before the tracer ran on the H100 and are
# not measured there yet (ROADMAP S4 re-decides each by in-call A/B):
# no stream compaction, per-bounce checkpointing, and the spectral state
# stored in bf16 (arithmetic still f32; per-ray deviation vs f32 is ~1%
# against ~300% per-ray MC noise — tests/test_bf16_state.py pins it).
COMPACT = ()
REMAT_BLOCK = 1
SPECTRAL_DTYPE = "bfloat16"


def build():
    """Returns (scene, cfg, origin, direction) for the flagship protocol."""
    import jax.numpy as jnp

    from demos.cornell_box import build_world
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.tracer.wavefront import RayConfig

    world = build_world(glass=True)
    scene = compile_scene(world, SpectralConfig(375.0, 740.0, BINS))
    cfg = RayConfig(
        max_depth=MAX_DEPTH,
        extinction_prob=0.1,
        extinction_min_depth=3,
        importance_sampling=True,
        important_path_weight=0.25,
        max_iters=MAX_ITERS,
        compact_schedule=COMPACT,
        remat_block=REMAT_BLOCK,
        spectral_dtype=SPECTRAL_DTYPE,
    )

    n = WIDTH * HEIGHT
    xs = (jnp.arange(WIDTH, dtype=jnp.float32) + 0.5) / WIDTH - 0.5
    ys = (jnp.arange(HEIGHT, dtype=jnp.float32) + 0.5) / HEIGHT - 0.5
    px, py = jnp.meshgrid(xs, ys, indexing="ij")
    d = jnp.stack(
        [px.ravel() * 0.8, py.ravel() * 0.8, jnp.ones(n, jnp.float32)], axis=-1
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -3.3], jnp.float32), (n, 3))
    return scene, cfg, o, d
