"""Run the tracer's main path on one GPU and check what comes out.

Usage:
    python chip_smoke.py             # every single-card phase, on one GPU
    python chip_smoke.py --cards 4   # only the sharded phase, on 4 GPUs

Each phase goes through the public entry points (``compile_scene``, the
wavefront tracer, ``observe()``, ``render_loss_and_grads``) and prints one
line: its name, sizes, compile and run seconds, and its comparison result.
The card's ``nvidia-smi`` name and power limit go on an earlier line. The
last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``.

The script exits non-zero and prints ``"ok": false`` when JAX finds no GPU,
when any phase raises, or when any comparison fails. It runs in one
process; the CPU comparisons use ``jax.devices("cpu")`` beside the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# reference sizes (demos/cornell_box.py, demos/prism.py, benchmarks/)
RENDER_PIXELS = (1024, 1024)
RENDER_SPP = 2  # cut from the reference's 250 to fit the run's time
GOLDEN_PIXELS = (64, 64)
GOLDEN_SPP = 64
INTERSECT_RAYS = 262_144
MESH_RAYS = 131_072
MESH_REF_RAYS = 1_024
TRAIN_STEPS = 5
TRAIN_CPU_RAYS = 4_096
PRISM_PIXELS = (512, 288)
PRISM_SPECTRAL_RAYS = 32
PRISM_SPP = 2  # cut from the demo's 100
SHARDED_RAYS = 65_536

# Tolerances, each with its reason:
# - intersect: same f32 program on two backends; only FMA contraction and
#   transcendental implementations differ (ulp level), amplified near
#   grazing hits, so winners agree on all but a few rays and t to 1e-4.
INTERSECT_WINNER_SHARE = 0.9999
INTERSECT_T_RTOL = 1e-4
# - mesh: the walk's Woop test and the reference's Moller-Trumbore pick the
#   same triangle except where a ray crosses a shared edge or vertex.
MESH_WINNER_SHARE = 0.999
MESH_TIE_RTOL = 1e-5
# - colour: the golden render's XYZ frame against its spectral frame
#   contracted with the CIE table in float64. Both pipelines project the
#   same samples and projection is linear, so f32 rounding (~1e-7 of each
#   pixel's |spectrum|.|CIE| sum) is all that may differ; a contraction run
#   in TF32 (10-bit mantissa) would differ by ~1e-4 to 1e-3.
COLOUR_RTOL = 1e-5
# - train: the two backends take the same random draws, so loss and
#   per-leaf gradient norms over 4,096 paths differ by f32 rounding alone
#   (on an H100: loss 5.5e-6, gradient norms 1.3e-3 relative, the latter
#   from the backward's summation order) until an ulp-level difference
#   flips a roulette or Fresnel choice and that path samples other bounces.
#   With no diverged path the limits are 1e-4 and 1e-2; each diverged share
#   f widens both by TRAIN_DIVERGED_WIDEN * f (a path's contribution spreads
#   over a few times the mean), and more than 1% diverged fails.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
TRAIN_DIVERGED_WIDEN = 4.0
TRAIN_MAX_DIVERGED = 0.01
# - sharded: the per-shard programs are identical, so radiance agrees to
#   f32 rounding of the collectives' summation order.
SHARDED_RTOL = 1e-5


class PhaseTimer:
    """Splits a phase's wall time into compile seconds (lowering plus XLA
    compilation, from JAX's monitoring events) and run seconds (the rest,
    including Python tracing and host work)."""

    def __init__(self):
        self.compile_s = 0.0
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, duration, **_):
        if event in ("/jax/core/compile/backend_compile_duration",
                     "/jax/core/compile/jaxpr_to_mlir_module_duration"):
            self.compile_s += duration

    def run(self, fn):
        c0, t0 = self.compile_s, time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        compile_s = self.compile_s - c0
        return out, compile_s, max(wall - compile_s, 0.0)


# --- phases -----------------------------------------------------------------


def _golden_checks(xyz):
    """tests/test_golden.py's checks on an XYZ frame of any resolution that
    divides into 8x8 blocks."""
    import numpy as np

    golden = np.load(os.path.join(ROOT, "tests", "data",
                                  "cornell_golden_blocks.npy"))
    nx, ny = xyz.shape[:2]
    blocks = xyz.reshape(8, nx // 8, 8, ny // 8, 3).mean(axis=(1, 3))
    mean_rel = abs(blocks[..., 1].mean() - golden[..., 1].mean()) / golden[..., 1].mean()
    rel = np.abs(blocks[..., 1] - golden[..., 1]) / np.maximum(golden[..., 1], 0.05)
    p90 = float(np.percentile(rel, 90))
    red, green = blocks[0, 4], blocks[7, 4]
    red_wall = red[0] / max(red[1], 1e-6) > green[0] / max(green[1], 1e-6)
    ok = bool(np.isfinite(xyz).all() and mean_rel < 0.05 and p90 < 0.25
              and red_wall)
    return ok, {"Y_mean_rel": round(float(mean_rel), 5),
                "block_rel_p90": round(p90, 4), "red_wall": bool(red_wall)}


def _cornell_camera(pixels, spp, extra_pipelines=(), **ray):
    from demos.cornell_box import build_world
    from source_tpu.core.math.transform import translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    rgb = RGBPipeline2D(accumulate=False)
    cam = PinholeCamera(pixels, parent=build_world(glass=True),
                        transform=translate(0, 0, -3.3),
                        pipelines=[rgb, *extra_pipelines])
    cam.pixel_samples = spp
    cam.spectral_bins = 15
    for k, v in ray.items():
        setattr(cam, k, v)
    cam.quiet = True
    return cam, rgb


def _colour_error(rgb, spec):
    """Largest |XYZ - spectrum . CIE| over all pixels and channels, each
    relative to that pixel's |spectrum| . |CIE| sum (float64 on the host)."""
    import numpy as np

    from source_tpu.optical.colour import resample_ciexyz

    lo, hi = spec.min_wavelength, spec.max_wavelength
    bins = spec.frame.mean.shape[-1]
    cie = np.asarray(resample_ciexyz(lo, hi, bins), np.float64)
    delta = float(np.float32((hi - lo) / bins))
    s = spec.frame.mean.reshape(-1, bins)
    err = np.abs(rgb.xyz_frame.mean.reshape(-1, 3) - s @ cie * delta)
    scale = np.abs(s) @ np.abs(cie) * delta
    return float(np.where(scale > 0, err / np.where(scale > 0, scale, 1.0),
                          err).max())


def phase_render(timer):
    """The reference Cornell box (glass on) through PinholeCamera.observe()
    at 1024x1024 and 15 bins, with the reference demo's ray settings."""
    cam, rgb = _cornell_camera(
        RENDER_PIXELS, RENDER_SPP, ray_importance_sampling=True,
        ray_important_path_weight=0.25, ray_max_depth=500,
        ray_extinction_min_depth=3, ray_extinction_prob=0.01,
        compact_schedule=((5, 3), (4, 4)))
    _, c, r = timer.run(lambda: cam.observe(seed=2024))
    ok, res = _golden_checks(rgb.xyz_frame.mean)
    res["rays_per_s"] = round(cam.rays_per_second, 1)
    sizes = (f"{RENDER_PIXELS[0]}x{RENDER_PIXELS[1]} px, 15 bins, "
             f"{RENDER_SPP} spp (reference 250)")
    return ok, sizes, c, r, res


def phase_golden(timer):
    """tests/test_golden.py's render on the card, with its tolerances; a
    spectral pipeline beside the RGB one checks the colour contraction."""
    from source_tpu.optical.observer import SpectralPowerPipeline2D

    spec = SpectralPowerPipeline2D(accumulate=False)
    cam, rgb = _cornell_camera(
        GOLDEN_PIXELS, GOLDEN_SPP, extra_pipelines=[spec], ray_max_depth=24,
        max_wavefront_iters=32, ray_extinction_prob=0.05)
    _, c, r = timer.run(lambda: cam.observe(seed=54321))
    ok, res = _golden_checks(rgb.xyz_frame.mean)
    res["colour_rel_max"] = _colour_error(rgb, spec)
    ok &= res["colour_rel_max"] <= COLOUR_RTOL
    return ok, f"{GOLDEN_PIXELS[0]}x{GOLDEN_PIXELS[1]} px, {GOLDEN_SPP} spp", c, r, res


def phase_furnace(timer):
    """An orthographic camera (unit ray weights) inside a unity-emitting
    sphere: every bin of every pixel reads exactly 1."""
    import numpy as np

    from source_tpu.core.scenegraph import World
    from source_tpu.optical.material import UnitySurfaceEmitter
    from source_tpu.optical.observer import (
        OrthographicCamera, SpectralRadiancePipeline2D,
    )
    from source_tpu.primitive import Sphere

    world = World()
    Sphere(radius=10.0, parent=world, material=UnitySurfaceEmitter())
    pipe = SpectralRadiancePipeline2D(accumulate=False)
    cam = OrthographicCamera((256, 256), width=1.0, parent=world,
                             pipelines=[pipe])
    cam.pixel_samples = 16
    cam.spectral_bins = 15
    cam.ray_extinction_prob = 0.0
    cam.quiet = True
    _, c, r = timer.run(lambda: cam.observe(seed=7))
    frame = pipe.frame.mean
    ok = bool(frame.shape == (256, 256, 15) and np.all(frame == 1.0))
    return ok, "256x256 px, 16 spp, 15 bins", c, r, {
        "bins_exactly_1": ok, "min": float(frame.min()),
        "max": float(frame.max())}


def _intersect_scenes():
    import numpy as np

    from demos.cornell_box import build_world as cornell
    from demos.csg import build_world as csg
    from demos.primitives.spherical_lenses import build_world as lenses

    # (name, builder, origin box lo, hi) — origins fill each scene's extent
    return [
        ("cornell_glass", lambda: cornell(glass=True),
         np.array([-1.0, -1.0, -3.3]), np.array([1.0, 1.0, 1.0])),
        ("csg_demo", csg, np.array([-4.0, -4.0, -6.0]),
         np.array([4.0, 4.0, 4.0])),
        ("lens_stack", lenses, np.array([-0.3, -0.3, -0.2]),
         np.array([0.3, 0.3, 0.9])),
    ]


def phase_intersect(timer):
    """intersect_scene on three scenes, GPU against the CPU backend."""
    import jax
    import numpy as np

    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.tracer.intersect import intersect_scene

    rng = np.random.default_rng(11)
    res, ok = {}, True
    compile_s = run_s = 0.0
    for name, build, lo, hi in _intersect_scenes():
        scene = compile_scene(build(), SpectralConfig(375.0, 740.0, 8))
        o = rng.uniform(lo, hi, (INTERSECT_RAYS, 3)).astype(np.float32)
        d = rng.normal(size=(INTERSECT_RAYS, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        fn = jax.jit(lambda s, o, d: intersect_scene(s, o, d))
        (gpu, c, r) = timer.run(
            lambda: jax.device_get(fn(scene, o, d)))
        compile_s += c
        run_s += r
        cpu = jax.device_get(fn(*jax.device_put((scene, o, d),
                                                jax.devices("cpu")[0])))
        same = (gpu.hit == cpu.hit) & np.where(gpu.hit, gpu.entity == cpu.entity, True)
        both = gpu.hit & cpu.hit & same
        dt = np.abs(gpu.t[both] - cpu.t[both]) / np.maximum(1.0, np.abs(cpu.t[both]))
        share = float(same.mean())
        t_max = float(dt.max()) if dt.size else 0.0
        exiting = float((gpu.exiting[both] == cpu.exiting[both]).mean()) if both.any() else 1.0
        scene_ok = share >= INTERSECT_WINNER_SHARE and t_max <= INTERSECT_T_RTOL
        ok &= bool(scene_ok and gpu.hit.mean() > 0.05)
        res[name] = {"hit_share": round(float(gpu.hit.mean()), 4),
                     "winner_agree": share, "t_rel_max": t_max,
                     "exiting_agree": exiting}
    return ok, f"{INTERSECT_RAYS} rays x 3 scenes", compile_s, run_s, res


def _all_pairs_winner(verts, tris, o, d, t_min, chunk=16_384):
    """Plain jnp all-pairs Moller-Trumbore (no epsilon pad): nearest t and
    triangle for each ray, scanning the triangles in chunks."""
    import jax
    import jax.numpy as jnp

    n_tri = tris.shape[0]
    pad = (-n_tri) % chunk
    a, b, c = (jnp.pad(verts[tris[:, k]], ((0, pad), (0, 0))) for k in range(3))
    ids = jnp.arange(n_tri + pad, dtype=jnp.int32)
    shape = (-1, chunk, 3)

    def body(carry, xs):
        t_best, i_best = carry
        a, b, c, idx = xs
        e1, e2 = b - a, c - a
        p = jnp.cross(d[:, None, :], e2[None])
        det = jnp.sum(e1[None] * p, -1)
        ok = jnp.abs(det) > 0.0
        inv = 1.0 / jnp.where(ok, det, 1.0)
        tv = o[:, None, :] - a[None]
        u = jnp.sum(tv * p, -1) * inv
        q = jnp.cross(tv, e1[None])
        v = jnp.sum(d[:, None, :] * q, -1) * inv
        t = jnp.sum(e2[None] * q, -1) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min[:, None])
        t = jnp.where(hit, t, jnp.inf)
        k = jnp.argmin(t, axis=1)
        tk = jnp.min(t, axis=1)
        better = tk < t_best
        return (jnp.where(better, tk, t_best),
                jnp.where(better, idx[k], i_best)), None

    init = (jnp.full(o.shape[0], jnp.inf, o.dtype),
            jnp.full(o.shape[0], -1, jnp.int32))
    with jax.default_matmul_precision("highest"):
        (t, i), _ = jax.lax.scan(body, init, (
            a.reshape(shape), b.reshape(shape), c.reshape(shape),
            ids.reshape(-1, chunk)))
    return t, jnp.where(jnp.isfinite(t), i, -1)


def phase_mesh(timer):
    """The 1.31M-triangle icosphere through mesh_intersect, against an
    all-pairs reference on a ray subset on the same card."""
    import jax
    import numpy as np

    from benchmarks.bigmesh import SUBDIVISIONS, icosphere, rays
    from source_tpu.accel.bvh import native_builder_available
    from source_tpu.primitive.mesh.data import MeshData
    from source_tpu.tracer.meshtrace import mesh_intersect

    t0 = time.perf_counter()
    v, f = icosphere(SUBDIVISIONS)
    tables = MeshData(v, f, smoothing=True, closed=True).to_tables(
        np.eye(4), np.eye(4))
    build_s = time.perf_counter() - t0
    o, d, tmin = rays(MESH_RAYS)
    fn = jax.jit(lambda m, o, d, t: mesh_intersect(m, o, d, t))
    out, c, _ = timer.run(lambda: jax.block_until_ready(fn(tables, o, d, tmin)))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(tables, o, d, tmin))
    r = time.perf_counter() - t0
    n = MESH_REF_RAYS
    ref_t, ref_i = jax.device_get(jax.jit(_all_pairs_winner)(
        tables.vertices, tables.triangles, o[:n], d[:n], tmin[:n]))
    got_t = np.asarray(out["t"])[:n]
    got_i = np.asarray(out["tri"])[:n]
    same = got_i == ref_i
    both = (got_i >= 0) & (ref_i >= 0)
    got_t, ref_t = np.where(both, got_t, 0.0), np.where(both, ref_t, 0.0)
    tie = ~same & both & (np.abs(got_t - ref_t) <= MESH_TIE_RTOL * np.abs(ref_t))
    share = float(same.mean())
    ok = bool(share >= MESH_WINNER_SHARE and (same | tie).all()
              and np.isfinite(np.asarray(out["t"])[np.asarray(out["tri"]) >= 0]).all())
    return ok, (f"{len(f)} tris, {MESH_RAYS} rays, reference on {n} rays"), c, r, {
        "same_winner": share, "grazing_ties": int(tie.sum()),
        "hit_share": round(float((np.asarray(out["tri"]) >= 0).mean()), 4),
        "bvh_builder": "native SAH" if native_builder_available() else "numpy fallback",
        "build_s": round(build_s, 2)}


def _float_leaves(tree):
    import jax

    return [x for x in jax.tree_util.tree_leaves(tree)
            if hasattr(x, "dtype") and x.dtype.kind == "f"]


def phase_train(timer):
    """The flagship program: 5 jitted render_loss_and_grads steps with an
    SGD update of the scene, then one 4,096-ray step against the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.flagship import BINS, HEIGHT, WIDTH, build
    from source_tpu.parallel.engine import render_batch, render_loss_and_grads

    scene, cfg, o, d = build()
    target = jnp.zeros((o.shape[0], BINS), jnp.float32)

    def sgd(s, g, lr=1e-3):
        return jax.tree_util.tree_map(
            lambda p, gp: p - lr * gp if p.dtype.kind == "f" else p, s, g)

    @jax.jit
    def step(s, key):
        loss, g = render_loss_and_grads(s, cfg, o, d, key, target)
        return sgd(s, g), loss, g

    times, compile_s, finite, nonzero = [], 0.0, True, False
    s = scene
    for i in range(TRAIN_STEPS):
        (s, loss, g), c, r = timer.run(
            lambda: jax.block_until_ready(step(s, jax.random.PRNGKey(i))))
        compile_s += c
        times.append(r)
        leaves = jax.device_get(_float_leaves(g))
        finite &= bool(np.isfinite(float(loss)) and all(np.isfinite(x).all() for x in leaves))
        nonzero |= any(np.abs(x).max() > 0 for x in leaves)
    step_s = float(np.median(times[1:]))

    # one small step on both backends with the same key and rays
    sub = slice(None, None, (WIDTH * HEIGHT) // TRAIN_CPU_RAYS)
    o4, d4, t4 = o[sub], d[sub], target[sub]
    key = jax.random.PRNGKey(99)

    def small(s, o, d, t):
        loss, g = render_loss_and_grads(s, cfg, o, d, key, t)
        final = render_batch(s, cfg, o, d, key, differentiable=True)
        return loss, [jnp.linalg.norm(x) for x in _float_leaves(g)], final.depth

    small = jax.jit(small)
    lg, ng, dg = jax.device_get(small(scene, o4, d4, t4))
    lc, nc, dc = jax.device_get(small(*jax.device_put(
        (scene, o4, d4, t4), jax.devices("cpu")[0])))
    loss_rel = abs(float(lg) - float(lc)) / max(abs(float(lc)), 1e-30)
    norm_rel = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                   for a, b in zip(ng, nc) if float(b) > 0)
    diverged = float((np.asarray(dg) != np.asarray(dc)).mean())
    widen = TRAIN_DIVERGED_WIDEN * diverged
    ok = bool(finite and nonzero and diverged <= TRAIN_MAX_DIVERGED
              and loss_rel <= TRAIN_LOSS_RTOL + widen
              and norm_rel <= TRAIN_GRAD_RTOL + widen)
    sizes = (f"{WIDTH}x{HEIGHT} rays, {BINS} bins, depth {cfg.max_depth}, "
             f"{TRAIN_STEPS} steps; CPU check on {TRAIN_CPU_RAYS} rays")
    return ok, sizes, compile_s, sum(times), {
        "step_ms_median": round(1e3 * step_s, 3), "finite": finite,
        "nonzero_grad": nonzero, "cpu_loss_rel": loss_rel,
        "cpu_grad_norm_rel_max": norm_rel, "diverged_paths": diverged}


def phase_prism(timer):
    """The dispersion demo through observe() with 32 spectral rays: one
    compile_scene per spectral slice, one compiled tile kernel for all."""
    import numpy as np

    from demos.prism import build_world
    from source_tpu.core import rotate, translate
    from source_tpu.optical.observer import PinholeCamera, RGBPipeline2D

    rgb = RGBPipeline2D(accumulate=False)
    cam = PinholeCamera(
        PRISM_PIXELS, fov=45, parent=build_world(),
        transform=translate(0, 0.075, -0.05) * rotate(180, -45, 0)
        * translate(0, 0, -0.75), pipelines=[rgb])
    cam.pixel_samples = PRISM_SPP
    cam.spectral_bins = 32
    cam.spectral_rays = PRISM_SPECTRAL_RAYS
    cam.ray_importance_sampling = True
    cam.ray_important_path_weight = 0.75
    cam.ray_max_depth = 100
    cam.max_wavefront_iters = 64
    cam.quiet = True
    _, c, r = timer.run(lambda: cam.observe(seed=7))
    xyz = rgb.xyz_frame.mean
    ok = bool(xyz.shape == PRISM_PIXELS + (3,) and np.isfinite(xyz).all()
              and (xyz >= 0).all() and xyz[..., 1].mean() > 0)
    return ok, (f"{PRISM_PIXELS[0]}x{PRISM_PIXELS[1]} px, 32 bins x "
                f"{PRISM_SPECTRAL_RAYS} spectral rays, {PRISM_SPP} spp "
                "(demo 100)"), c, r, {
        "Y_mean": float(xyz[..., 1].mean()), "finite": ok}


def phase_sharded(timer, n_cards):
    """sharded_render_batch and sharded_render_loss_and_grads on an
    n-card mesh over the rays axis, against the serial run of the same
    per-shard programs on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.flagship import BINS, build
    from source_tpu.parallel.engine import (
        default_mesh, sharded_render_batch, sharded_render_loss_and_grads,
    )
    from source_tpu.tracer.wavefront import init_rays, trace_rays, trace_rays_diff

    devices = jax.devices()[:n_cards]
    if len(devices) != n_cards:
        raise RuntimeError(f"need {n_cards} cards, found {len(jax.devices())}")
    mesh = default_mesh(devices)
    scene, cfg, o, d = build()
    n = SHARDED_RAYS
    o, d = o[::o.shape[0] // n], d[::d.shape[0] // n]
    target = jnp.zeros((n, BINS), jnp.float32)
    key = jax.random.PRNGKey(5)

    fwd = jax.jit(lambda s, o, d, k: sharded_render_batch(s, cfg, o, d, k, mesh=mesh))
    grad = jax.jit(lambda s, o, d, k, t: sharded_render_loss_and_grads(
        s, cfg, o, d, k, t, mesh=mesh))
    (sh, (loss_s, g_s)), c, r = timer.run(lambda: jax.block_until_ready(
        (fwd(scene, o, d, key), grad(scene, o, d, key, target))))

    shard = n // n_cards
    one = devices[0]

    @jax.jit
    def serial(s, o, d, t):
        rads = []
        for i in range(n_cards):
            sl = slice(i * shard, (i + 1) * shard)
            st = init_rays(o[sl], d[sl], s.bins, spectral_dtype=cfg.spectral_dtype)
            rads.append(trace_rays(s, cfg, st, jax.random.fold_in(key, i)).radiance)
        return jnp.concatenate(rads)

    def serial_loss(s, o, d, t):
        total = 0.0
        for i in range(n_cards):
            sl = slice(i * shard, (i + 1) * shard)
            st = init_rays(o[sl], d[sl], s.bins, spectral_dtype=cfg.spectral_dtype)
            fin = trace_rays_diff(s, cfg, st, jax.random.fold_in(key, i))
            err = (fin.radiance - t[sl]).astype(jnp.float32)
            total = total + jnp.sum(err * err)
        return total / (n * BINS)

    args = jax.device_put((scene, o, d, target), one)
    rad_r = np.asarray(serial(*args), np.float32)
    loss_r, g_r = jax.jit(jax.value_and_grad(serial_loss, allow_int=True))(*args)
    rad_s = np.asarray(sh.radiance, np.float32)
    rad_bitwise = bool(np.array_equal(rad_s, rad_r))
    rad_rel = float(np.abs(rad_s - rad_r).max() / max(np.abs(rad_r).max(), 1e-30))
    loss_rel = abs(float(loss_s) - float(loss_r)) / max(abs(float(loss_r)), 1e-30)
    g_rel = 0.0
    for a, b in zip(_float_leaves(g_s), _float_leaves(g_r)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-12)
        g_rel = max(g_rel, float(np.abs(a - b).max() / scale))
    ok = bool(rad_rel <= SHARDED_RTOL and loss_rel <= SHARDED_RTOL
              and g_rel <= SHARDED_RTOL)
    return ok, f"{n} rays over {n_cards} cards, {BINS} bins", c, r, {
        "radiance_bitwise": rad_bitwise, "radiance_rel_max": rad_rel,
        "loss_rel": loss_rel, "grad_rel_max": g_rel}


PHASES = [("render", phase_render), ("golden", phase_golden),
          ("furnace", phase_furnace), ("intersect", phase_intersect),
          ("mesh", phase_mesh), ("train", phase_train), ("prism", phase_prism)]


# --- driver -------------------------------------------------------------------


def _nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def result_line(ok, devices):
    """The last line of standard output: ok plus the device as JAX reports
    it."""
    return json.dumps({"ok": bool(ok), "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=1,
                        help="4 runs only the sharded phase on 4 cards")
    args = parser.parse_args(argv)

    # keep the CPU backend beside the GPU for the comparisons
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, ROOT)
    try:
        import jax

        from source_tpu.runtime import enable_compile_cache
    except ImportError as exc:
        print(json.dumps({"ok": False, "error": f"import failed: {exc}"}))
        return 2

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(json.dumps({"ok": False, "error":
                          f"no GPU: JAX found {devices[0].platform}"}))
        return 2
    cache = enable_compile_cache()
    print(_nvidia_smi(), flush=True)  # name, power limit: one line per card
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
          f"compile cache {cache}", flush=True)

    timer = PhaseTimer()
    if args.cards > 1:
        phases = [("sharded", lambda t: phase_sharded(t, args.cards))]
    else:
        phases = PHASES
    all_ok = True
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            ok, sizes, compile_s, run_s, result = phase(timer)
        except Exception:  # a phase failure is reported, never swallowed
            traceback.print_exc()
            ok, sizes, compile_s, run_s, result = False, "-", 0.0, 0.0, {
                "error": traceback.format_exc().strip().splitlines()[-1]}
        all_ok &= ok
        print(f"phase {name}: {'ok' if ok else 'FAILED'} | {sizes} | "
              f"compile {compile_s:.2f}s run {run_s:.2f}s "
              f"(wall {time.perf_counter() - t0:.2f}s) | "
              f"{json.dumps(result)}", flush=True)

    print(result_line(all_ok, devices))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
