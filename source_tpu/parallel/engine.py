"""Multi-device rendering and differentiable-render training steps.

Device-mesh replacement for the reference's MulticoreEngine task farm
(raysect/core/workflow.py:123-326, SURVEY.md §2.12): the DP axis is the ray
batch. Scene tables (a few KB) are replicated to every device; pixel tiles
are sharded along a 1-D ``rays`` mesh axis; per-pixel statistics come back
sharded and fold on the host, so the only collective in the forward pass is
the final gather. For differentiable rendering, parameter gradients are
reduced across the mesh by XLA (psum inserted automatically from the
replicated-in/replicated-out sharding contract), overlapping with the
backward pass.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..compiler.scene import CompiledScene
from ..tracer.wavefront import (
    RayConfig, RayState, init_rays, trace_rays, trace_rays_diff,
)

__all__ = ["default_mesh", "ShardedEngine", "render_batch", "render_loss_and_grads",
           "sharded_render_batch", "sharded_render_loss_and_grads",
           "RenderEngine", "SerialEngine", "MulticoreEngine"]


def default_mesh(devices=None, axis_name="rays"):
    """A 1-D mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class ShardedEngine:
    """Render-engine strategy sharding pixel tiles across a device mesh.

    Passed to observers as ``render_engine``; the observer's tile kernel is
    jitted with the ray/tile axis sharded over ``axis_name`` and scene
    tables replicated.
    """

    def __init__(self, mesh=None, axis_name="rays"):
        self.mesh = mesh if mesh is not None else default_mesh()
        self.axis_name = axis_name

    @property
    def n_devices(self):
        return self.mesh.devices.size

    def shard_map_trace(self, scene, cfg, origin, direction, key,
                        weight=None, differentiable=False):
        """Trace a ray batch with the production tracer shard_mapped over
        this engine's mesh (see ``sharded_render_batch``)."""
        return sharded_render_batch(
            scene, cfg, origin, direction, key, mesh=self.mesh,
            axis_name=self.axis_name, weight=weight,
            differentiable=differentiable)


def render_batch(scene: CompiledScene, cfg: RayConfig, origin, direction, key,
                 weight=None, differentiable=False):
    """Trace a ray batch and return the final RayState. The shared device
    entry point used by engines, the bench and the graft entry."""
    state = init_rays(origin, direction, scene.bins, weight,
                      spectral_dtype=cfg.spectral_dtype)
    tracer = trace_rays_diff if differentiable else trace_rays
    return tracer(scene, cfg, state, key)


def render_loss_and_grads(scene: CompiledScene, cfg: RayConfig, origin,
                          direction, key, target):
    """Differentiable-rendering training step: L2 loss between the traced
    per-ray spectra and a target, with gradients w.r.t. every scene
    parameter (geometry transforms, primitive params, material spectra).

    Under a sharded jit, XLA all-reduces the scene-parameter gradients
    across the ray axis automatically (BASELINE north star).
    """

    def loss_fn(scene):
        final = render_batch(
            scene, cfg, origin, direction, key, differentiable=True
        )
        return jnp.mean((final.radiance - target) ** 2)

    # allow_int: integer tables (entity/material ids) get symbolic-zero
    # gradients; the float leaves (transforms, params, spectra) are the
    # differentiable scene parameters
    return jax.value_and_grad(loss_fn, allow_int=True)(scene)


def _state_specs(axis_name):
    """PartitionSpec pytree for a RayState: lane-indexed fields shard over
    the rays axis; the segment/overflow counters come back replicated
    (psum'd inside the shard_map body)."""
    shard = P(axis_name)
    repl = P()
    return RayState(origin=shard, direction=shard, throughput=shard,
                    radiance=shard, alive=shard, depth=shard,
                    segments=repl, overflow=repl)


def sharded_render_batch(scene: CompiledScene, cfg: RayConfig, origin,
                         direction, key, mesh=None, axis_name="rays",
                         weight=None, differentiable=False):
    """``render_batch`` under ``jax.shard_map``: every device runs the FULL
    production tracer on its local ray shard. The per-shard RNG key is
    ``fold_in(key, axis_index)``, so a single-device run of the same
    per-shard programs is bit-identical on the CPU mesh
    (tests/test_sharding.py::test_sharded_fused_trace_parity).

    Scene tables replicate (a few KB); lane-indexed state shards over
    ``axis_name``; segments/overflow are psum'd. Stream compaction, when
    enabled, sorts each shard locally — no cross-device collective.
    Reference: the engine farms the actual render callable to workers
    (raysect/core/workflow.py:199-254).
    """
    mesh = mesh if mesh is not None else default_mesh(axis_name=axis_name)
    have_w = weight is not None
    shard = P(axis_name)

    def local(scene, o, d, w, key):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        st = init_rays(o, d, scene.bins, w if have_w else None,
                       spectral_dtype=cfg.spectral_dtype)
        tracer = trace_rays_diff if differentiable else trace_rays
        final = tracer(scene, cfg, st, key)
        return dataclasses.replace(
            final,
            segments=jax.lax.psum(final.segments, axis_name),
            overflow=jax.lax.psum(final.overflow, axis_name))

    w_arg = weight if have_w else jnp.zeros((origin.shape[0],), origin.dtype)
    # jit: shard_map cannot evaluate the tracer's checkpointed scan eagerly
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, check_vma=False,
        in_specs=(P(), shard, shard, shard, P()),
        out_specs=_state_specs(axis_name)))
    return fn(scene, origin, direction, w_arg, key)


def sharded_render_loss_and_grads(scene: CompiledScene, cfg: RayConfig,
                                  origin, direction, key, target, mesh=None,
                                  axis_name="rays"):
    """``render_loss_and_grads`` with the trace shard_mapped over the rays
    axis. Differentiating through shard_map psums the replicated scene
    pytree's cotangents across shards automatically (the shard_map
    transpose), so parameter gradients match the single-device run of the
    same per-shard programs."""
    mesh = mesh if mesh is not None else default_mesh(axis_name=axis_name)
    n_total = origin.shape[0] * target.shape[-1]
    shard = P(axis_name)

    def loss_fn(scene):
        def local(scene, o, d, tgt, key):
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            st = init_rays(o, d, scene.bins,
                           spectral_dtype=cfg.spectral_dtype)
            final = trace_rays_diff(scene, cfg, st, key)
            err = (final.radiance - tgt).astype(jnp.float32)
            return jax.lax.psum(jnp.sum(err * err), axis_name)

        total = jax.jit(jax.shard_map(
            local, mesh=mesh, check_vma=False,
            in_specs=(P(), shard, shard, shard, P()),
            out_specs=P()))(scene, origin, direction, target, key)
        return total / n_total

    return jax.value_and_grad(loss_fn, allow_int=True)(scene)


class RenderEngine:
    """Render-engine strategy contract (reference core/workflow.py:35-97).

    The reference farms picklable (task, render, update) triples to worker
    processes; here engines orchestrate device work instead — observers
    consult ``worker_count()`` for tile sizing and engines may shard the
    tile kernel over a device mesh.
    """

    def run(self, tasks, render, update, render_args=(), update_args=()):
        raise NotImplementedError

    def worker_count(self):
        raise NotImplementedError


class SerialEngine(RenderEngine):
    """In-order host loop (reference core/workflow.py:100-120): debugging
    aid and the semantics reference for engine implementations."""

    def run(self, tasks, render, update, render_args=(), update_args=()):
        for task in tasks:
            update(render(task, *render_args), *update_args)

    def worker_count(self):
        return 1


class MulticoreEngine(ShardedEngine, RenderEngine):
    """Name-parity alias for the reference's default engine
    (core/workflow.py:123): here the "cores" are mesh devices and the
    task farm is the sharded tile kernel; the serial ``run`` contract is
    honoured for host-side task lists."""

    def run(self, tasks, render, update, render_args=(), update_args=()):
        for task in tasks:
            update(render(task, *render_args), *update_args)

    def worker_count(self):
        return self.n_devices
