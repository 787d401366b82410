"""Headline benchmark: Cornell box 512x512 forward+backward rays/s per chip.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "rays/s/chip", "device": ..., ...}

Protocol (BASELINE.md): the reference (raysect) publishes no numbers and
cannot be built in this image (no cython), so ``vs_baseline_estimated`` is
computed against a documented ESTIMATE of the reference's multicore-CPU
throughput on the same scene: 2.0e5 rays/s (raysect's canonical unit,
printed by optical/observer/base/observer.pyx:500-511; typical order for
the Cornell box demo on a modern multicore host).

The measured quantity is path *segments* traced per second through the full
differentiable pipeline (forward wavefront trace + reverse-mode gradients
w.r.t. every scene parameter), which matches the reference's ray accounting
(daughter rays counted individually).

Repeats protocol: GROUPS calls, each ONE jitted program running
STEPS_PER_GROUP full training steps chained through a lax.scan (per-step
grads folded into the carry so nothing dead-codes) — the shape of a jitted
training loop, so the per-call dispatch and host synchronisation are
amortised over the steps. The single-call blocked latency (dispatch + sync
included) is reported separately.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_CPU_RAYS_PER_S = 2.0e5  # documented estimate, see module docstring

GROUPS = 4
STEPS_PER_GROUP = 10


def main():
    import jax
    import jax.numpy as jnp

    from benchmarks.flagship import BINS, build
    from source_tpu.parallel.engine import render_batch, render_loss_and_grads
    from source_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    scene, cfg, o, d = build()
    target = jnp.zeros((o.shape[0], BINS), jnp.float32)

    fwd = jax.jit(
        lambda s, key: render_batch(s, cfg, o, d, key)
    )
    step = jax.jit(
        lambda s, key: render_loss_and_grads(s, cfg, o, d, key, target)
    )

    def multi_step(s, key):
        """STEPS_PER_GROUP chained training steps in ONE program: every
        step's scene-parameter grads fold into the carry (consumed, so the
        backward can't dead-code away) — the shape of a real jitted
        training loop."""

        def body(carry, k):
            loss, grads = render_loss_and_grads(s, cfg, o, d, k, target)
            gsum = sum(
                jnp.sum(jnp.abs(l)) for l in jax.tree_util.tree_leaves(grads)
                if hasattr(l, "dtype") and l.dtype.kind == "f"
            )
            return carry + loss + gsum * 1e-20, None

        keys = jax.random.split(key, STEPS_PER_GROUP)
        tot, _ = jax.lax.scan(body, jnp.float32(0), keys)
        return tot

    multi_step = jax.jit(multi_step)

    # segment count for the rays/s denominator (forward pass, same estimator)
    key = jax.random.PRNGKey(0)
    final = fwd(scene, key)
    segments = int(final.segments)

    # warmup/compile
    loss, grads = step(scene, key)
    jax.block_until_ready((loss, grads))
    # single blocked step: includes one full host<->device round trip
    t0 = time.perf_counter()
    jax.block_until_ready(step(scene, jax.random.PRNGKey(999)))
    latency_s = time.perf_counter() - t0
    # timed groups: each group is ONE call running STEPS_PER_GROUP steps
    jax.block_until_ready(multi_step(scene, jax.random.PRNGKey(123)))
    times = []
    for g in range(GROUPS):
        t0 = time.perf_counter()
        out = multi_step(scene, jax.random.PRNGKey(g * 100 + 1))
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / STEPS_PER_GROUP)
    times.sort()
    median = times[len(times) // 2]
    spread = (times[-1] - times[0]) / median

    rays_per_s = segments / median

    print(
        json.dumps(
            {
                "metric": "cornell_box_512_fwd_bwd",
                "value": round(rays_per_s, 1),
                "unit": "rays/s/chip",
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
                "vs_baseline_estimated": round(
                    rays_per_s / REFERENCE_CPU_RAYS_PER_S, 3),
                "repeats": GROUPS * STEPS_PER_GROUP,
                "spread_pct": round(100.0 * spread, 1),
                "step_ms_median": round(1e3 * median, 2),
                "blocked_step_ms": round(1e3 * latency_s, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
