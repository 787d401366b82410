"""User-facing optical Ray: single-ray / sampled spectral queries.

Counterpart of the reference's optical ``Ray`` (optical/ray.pyx:43-549):
construct with an origin/direction and a spectral configuration, then
``trace(world)`` for one path sample or ``sample(world, count)`` for a
mean spectrum. The reference traces recursively per ray; here ``sample``
maps to ONE wavefront batch of ``count`` identical camera rays (the
vectorised expression of ray.pyx:459-504's averaging loop), so a million
samples cost one kernel launch. ``spawn_daughter`` (ray.pyx:506) has no
host-side counterpart — daughter rays are masked continuation lanes
inside the wavefront kernel (tracer/wavefront.py).
"""

from __future__ import annotations

import numpy as np

from .spectrum import Spectrum

__all__ = ["Ray"]


def _as3(v, default):
    if v is None:
        return np.asarray(default, np.float32)
    if hasattr(v, "x"):
        return np.asarray([v.x, v.y, v.z], np.float32)
    return np.asarray(list(v), np.float32)


class Ray:
    """Spectral ray with the reference's trace/sample API and defaults
    (optical/ray.pyx:85-126)."""

    def __init__(self, origin=None, direction=None, min_wavelength=375.0,
                 max_wavelength=740.0, bins=15, max_distance=None,
                 extinction_prob=0.1, extinction_min_depth=3, max_depth=100,
                 importance_sampling=True, important_path_weight=0.25):
        if min_wavelength <= 0 or max_wavelength <= min_wavelength:
            raise ValueError("Wavelength range is invalid.")
        if bins < 1:
            raise ValueError("bins must be >= 1.")
        if not 0 <= extinction_prob <= 1:
            raise ValueError("extinction_prob must lie in [0, 1].")
        if not 0 <= important_path_weight <= 1:
            raise ValueError("important_path_weight must lie in [0, 1].")
        self.origin = _as3(origin, (0.0, 0.0, 0.0))
        self.direction = _as3(direction, (0.0, 0.0, 1.0))
        self.min_wavelength = float(min_wavelength)
        self.max_wavelength = float(max_wavelength)
        self.bins = int(bins)
        self.max_distance = (
            float("inf") if max_distance is None else float(max_distance)
        )
        self.extinction_prob = float(extinction_prob)
        self.extinction_min_depth = int(extinction_min_depth)
        self.max_depth = int(max_depth)
        self.importance_sampling = bool(importance_sampling)
        self.important_path_weight = float(important_path_weight)
        self.ray_count = 0  # statistics counter (ray.pyx primary-ray stats)

    def _config(self, max_iters=None):
        from ..tracer.wavefront import RayConfig

        return RayConfig(
            max_depth=self.max_depth,
            extinction_prob=self.extinction_prob,
            extinction_min_depth=self.extinction_min_depth,
            importance_sampling=self.importance_sampling,
            important_path_weight=self.important_path_weight,
            max_iters=max_iters if max_iters is not None else min(self.max_depth + 8, 256),
            max_distance=self.max_distance,
        )

    def new_spectrum(self):
        """Empty spectrum matching this ray's spectral configuration
        (ray.pyx new_spectrum)."""
        return Spectrum(self.min_wavelength, self.max_wavelength, self.bins)

    def trace(self, world, seed=0):
        """One Monte-Carlo path sample; returns a Spectrum (ray.pyx:338)."""
        return self.sample(world, 1, seed=seed)

    def sample(self, world, count, seed=0):
        """Mean spectrum over ``count`` path samples (ray.pyx:459-504),
        traced as a single wavefront batch."""
        import jax
        import jax.numpy as jnp

        from ..compiler.scene import SpectralConfig, compile_scene
        from ..parallel.engine import render_batch

        if count < 1:
            raise ValueError("count must be >= 1.")
        scene = compile_scene(
            world, SpectralConfig(self.min_wavelength, self.max_wavelength, self.bins)
        )
        o = jnp.broadcast_to(jnp.asarray(self.origin), (count, 3))
        d = jnp.broadcast_to(jnp.asarray(self.direction), (count, 3))
        final = render_batch(scene, self._config(), o, d, jax.random.PRNGKey(seed))
        self.ray_count += int(final.segments)
        mean = np.asarray(final.radiance).mean(axis=0)
        return Spectrum(self.min_wavelength, self.max_wavelength, self.bins, mean)

    def copy(self, origin=None, direction=None):
        """Copy with optional new origin/direction (ray.pyx copy)."""
        return Ray(
            origin=self.origin if origin is None else origin,
            direction=self.direction if direction is None else direction,
            min_wavelength=self.min_wavelength,
            max_wavelength=self.max_wavelength,
            bins=self.bins,
            max_distance=self.max_distance,
            extinction_prob=self.extinction_prob,
            extinction_min_depth=self.extinction_min_depth,
            max_depth=self.max_depth,
            importance_sampling=self.importance_sampling,
            important_path_weight=self.important_path_weight,
        )
