"""XLA cost-model work and achieved rates for the flagship benchmark program.

Jits the SAME program bench.py times (benchmarks/flagship.py: glass Cornell
512x512, identical RayConfig), reads XLA's cost model for the compiled
binary (FLOPs and bytes accessed), measures wall time, and prints the
achieved FLOP/s and bytes/s with the device they ran on. It divides by no
peak: the H100 peak table comes with the benchmark (ROADMAP S1).

Usage: python benchmarks/mfu.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from benchmarks.flagship import BINS, build
    from source_tpu.parallel.engine import render_batch, render_loss_and_grads
    from source_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    scene, cfg, o, d = build()
    target = jnp.zeros((o.shape[0], BINS), jnp.float32)
    key = jax.random.PRNGKey(0)

    # actual traced segments (roulette-truncated) — the SAME denominator
    # bench.py uses
    segments = int(jax.jit(
        lambda s, k: render_batch(s, cfg, o, d, k).segments
    )(scene, key))

    for name, fn in [
        ("forward", lambda s, k: render_batch(s, cfg, o, d, k).radiance),
        ("fwd_bwd", lambda s, k: render_loss_and_grads(s, cfg, o, d, k, target)),
    ]:
        compiled = jax.jit(fn).lower(scene, key).compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):  # older jax returns [dict]
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        bytes_accessed = float(cost.get("bytes accessed", 0.0))

        jax.block_until_ready(compiled(scene, key))
        reps = 3
        t0 = time.perf_counter()
        for i in range(reps):
            out = compiled(scene, jax.random.PRNGKey(i + 1))
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "program": name, "device_kind": jax.devices()[0].device_kind,
            "wall_s": round(dt, 6), "xla_flops": flops,
            "xla_bytes": bytes_accessed,
            "achieved_tflops": round(flops / dt / 1e12, 4),
            "achieved_gbs": round(bytes_accessed / dt / 1e9, 2),
            "segments_per_s": round(segments / dt, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
