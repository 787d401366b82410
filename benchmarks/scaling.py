"""Weak-scaling harness: rays/s vs device count (BASELINE ≥85% efficiency).

Shards the flagship Cornell-box forward+backward step over 1/2/4/8-device
meshes with a FIXED per-device ray batch (weak scaling) and reports
efficiency = throughput(N) / (N * throughput(1)). Runs on whatever devices
JAX finds: the cards of one host, or a virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8),
where all "devices" share one host's cores, so the efficiency measures
host-core oversubscription and validates only the mechanism.

Usage: python benchmarks/scaling.py [rays_per_device]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BINS = 8
STEPS = 3


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from demos.cornell_box import build_world
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import render_loss_and_grads
    from source_tpu.runtime import enable_compile_cache
    from source_tpu.tracer.wavefront import RayConfig

    enable_compile_cache()
    rays_per_device = int(sys.argv[1]) if len(sys.argv) > 1 else 4096

    world = build_world(glass=True)
    scene = compile_scene(world, SpectralConfig(375.0, 740.0, BINS))
    cfg = RayConfig(max_depth=12, extinction_prob=0.1, extinction_min_depth=3,
                    max_iters=16)

    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    results = {}
    base_rate = None
    for n in counts:
        mesh = Mesh(np.asarray(devices[:n]), ("rays",))
        tile = NamedSharding(mesh, P("rays"))
        repl = NamedSharding(mesh, P())
        n_rays = rays_per_device * n
        key = jax.random.PRNGKey(0)
        u = jax.random.uniform(key, (n_rays, 2))
        d = jnp.stack(
            [(u[:, 0] - 0.5) * 0.6, (u[:, 1] - 0.5) * 0.6,
             jnp.ones(n_rays)], axis=-1)
        d = jax.device_put(d / jnp.linalg.norm(d, axis=-1, keepdims=True), tile)
        o = jax.device_put(
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, -3.3], jnp.float32),
                             (n_rays, 3)), tile)
        target = jax.device_put(jnp.zeros((n_rays, BINS), jnp.float32), tile)

        step = jax.jit(
            lambda s, key: render_loss_and_grads(s, cfg, o, d, key, target),
            in_shardings=(None, repl),
        )
        loss, grads = step(scene, key)  # compile
        jax.block_until_ready(loss)
        t0 = time.perf_counter()
        for i in range(STEPS):
            loss, grads = step(scene, jax.random.PRNGKey(i + 1))
        jax.block_until_ready(loss)
        dt = (time.perf_counter() - t0) / STEPS
        rate = n_rays * cfg.max_iters / dt  # upper-bound segment rate
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        results[str(n)] = {
            "rays": n_rays, "step_s": round(dt, 4),
            "rate": round(rate, 1), "efficiency": round(eff, 4),
        }
        print(json.dumps({"devices": n, **results[str(n)]}), flush=True)

    worst = min(v["efficiency"] for v in results.values())
    print(json.dumps({"worst_efficiency": round(worst, 4),
                      "device_kind": devices[0].device_kind}))


if __name__ == "__main__":
    main()
