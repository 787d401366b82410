"""Multi-device sharding: observer tile kernel over an 8-device mesh.

Runs on the virtual CPU mesh (conftest forces
xla_force_host_platform_device_count=8). Validates SURVEY.md §2.12: pixel
tiles shard as the DP axis, scene tables replicate, results match the
single-device render.
"""

import numpy as np

import jax


def test_sharded_observe_matches_single_device():
    from source_tpu.core.scenegraph import World
    from source_tpu.optical.material import UnitySurfaceEmitter
    from source_tpu.optical.observer import OrthographicCamera, PowerPipeline2D
    from source_tpu.parallel.engine import ShardedEngine
    from source_tpu.primitive import Sphere

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"

    def render(engine):
        w = World()
        Sphere(radius=10.0, parent=w, material=UnitySurfaceEmitter())
        pipe = PowerPipeline2D(accumulate=False)
        cam = OrthographicCamera(pixels=(16, 16), width=1.0, pipelines=[pipe],
                                 parent=w, render_engine=engine)
        cam.pixel_samples = 8
        cam.ray_extinction_prob = 0.0
        cam.tile_size = 256  # divisible by 8 devices
        cam.quiet = True
        cam.observe(seed=3)
        return pipe.frame.mean.copy()

    single = render(None)
    sharded = render(ShardedEngine())
    assert np.allclose(single, sharded, rtol=1e-6)
    # furnace closed form: unit-sensitivity orthographic pixels read the
    # spectrally integrated unity radiance directly
    assert np.allclose(sharded, 365.0, rtol=1e-5)


def test_sharded_render_loss_and_grads():
    """Differentiable render over the mesh: gradients replicate correctly."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from demos.cornell_box import build_world
    from source_tpu.compiler import SpectralConfig, compile_scene
    from source_tpu.parallel.engine import default_mesh, render_loss_and_grads
    from source_tpu.tracer.wavefront import RayConfig

    scene = compile_scene(build_world(glass=False), SpectralConfig(375., 740., 4))
    mesh = default_mesh()
    n = 1024
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (n, 2))
    d = jnp.stack([(u[:, 0] - .5) * .8, (u[:, 1] - .5) * .8, jnp.ones(n)], -1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(jnp.asarray([0., 0., -3.3]), (n, 3))
    target = jnp.zeros((n, 4))
    cfg = RayConfig(max_depth=8, extinction_prob=0.1, extinction_min_depth=3,
                    importance_sampling=True, important_path_weight=0.25,
                    max_iters=10)

    tile = NamedSharding(mesh, P("rays"))
    repl = NamedSharding(mesh, P())
    fn = jax.jit(
        lambda s, o, d, k, t: render_loss_and_grads(s, cfg, o, d, k, t),
        in_shardings=(None, tile, tile, repl, tile),
    )
    loss_sh, grads_sh = fn(scene, o, d, jax.random.PRNGKey(1), target)
    loss_1, grads_1 = jax.jit(
        lambda s, o, d, k, t: render_loss_and_grads(s, cfg, o, d, k, t)
    )(scene, o, d, jax.random.PRNGKey(1), target)
    assert abs(float(loss_sh) - float(loss_1)) < 1e-5 * max(1.0, abs(float(loss_1)))
    g_sh = jax.tree_util.tree_leaves(grads_sh)
    g_1 = jax.tree_util.tree_leaves(grads_1)
    for a, b in zip(g_sh, g_1):
        if jnp.issubdtype(a.dtype, jnp.floating):
            assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def _cornell_scene(bins=5):
    from demos.cornell_box import build_world
    from source_tpu.compiler import SpectralConfig, compile_scene

    return compile_scene(build_world(glass=True),
                         SpectralConfig(375.0, 740.0, bins))


def _ray_fan(n, seed=0):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    o = jnp.asarray(
        np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)),
                        np.full((n, 1), -2.5)], axis=1), jnp.float32)
    d = rng.normal(size=(n, 3)) + np.array([0, 0, 4.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


def test_sharded_fused_trace_parity():
    """The production XLA wavefront tracer under jax.shard_map matches
    single-device execution of the same per-shard programs BIT-FOR-BIT
    (per-shard RNG = fold_in(key, axis_index), so the reference is the
    serial loop over shards)."""
    from source_tpu.parallel.engine import default_mesh, sharded_render_batch
    from source_tpu.tracer.wavefront import RayConfig, init_rays, trace_rays

    n_dev = len(jax.devices())
    assert n_dev == 8
    n = 1024
    o, d = _ray_fan(n, seed=4)
    key = jax.random.PRNGKey(21)
    cfg = RayConfig(max_depth=6, extinction_prob=0.1, extinction_min_depth=3,
                    max_iters=6, compact_schedule=(), early_exit=False)
    scene = _cornell_scene()
    sharded = sharded_render_batch(
        scene, cfg, o, d, key, mesh=default_mesh())
    rad_s = np.asarray(sharded.radiance)
    seg_s = int(sharded.segments)

    shard_n = n // n_dev
    rads, segs = [], 0
    for i in range(n_dev):
        st = init_rays(o[i * shard_n:(i + 1) * shard_n],
                       d[i * shard_n:(i + 1) * shard_n], scene.bins)
        ref = trace_rays(scene, cfg, st, jax.random.fold_in(key, i))
        rads.append(np.asarray(ref.radiance))
        segs += int(ref.segments)
    np.testing.assert_array_equal(np.concatenate(rads), rad_s)
    assert segs == seg_s


def test_sharded_fused_loss_and_grads():
    """Sharded differentiable render on the XLA route: loss and
    scene-table gradients match the serial per-shard reference."""
    import jax.numpy as jnp

    from source_tpu.parallel.engine import (
        default_mesh, sharded_render_loss_and_grads,
    )
    from source_tpu.tracer.wavefront import RayConfig, init_rays, trace_rays_diff

    n_dev = len(jax.devices())
    n = 512
    o, d = _ray_fan(n, seed=5)
    key = jax.random.PRNGKey(3)
    cfg = RayConfig(max_depth=4, extinction_prob=0.1, extinction_min_depth=2,
                    max_iters=4, compact_schedule=(), early_exit=False)
    scene = _cornell_scene(bins=4)
    target = jnp.zeros((n, 4), jnp.float32)
    loss_s, grads_s = sharded_render_loss_and_grads(
        scene, cfg, o, d, key, target, mesh=default_mesh())

    def ref_loss(scene):
        total = 0.0
        shard_n = n // n_dev
        for i in range(n_dev):
            sl = slice(i * shard_n, (i + 1) * shard_n)
            st = init_rays(o[sl], d[sl], scene.bins)
            final = trace_rays_diff(scene, cfg, st,
                                    jax.random.fold_in(key, i))
            total = total + jnp.sum((final.radiance - target[sl]) ** 2)
        return total / (n * 4)

    loss_r, grads_r = jax.value_and_grad(ref_loss, allow_int=True)(scene)
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-6)
    for f in ["leaf_w2l", "leaf_params", "mat_params", "mat_spectra",
              "mat_scalars"]:
        a = np.asarray(getattr(grads_r, f), np.float64)
        b = np.asarray(getattr(grads_s, f), np.float64)
        assert np.isfinite(b).all(), f
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=1e-5,
                                   err_msg=f)
