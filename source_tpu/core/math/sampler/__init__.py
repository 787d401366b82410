"""Sampler classes: solid-angle, surface and targeted samplers.

Counterparts of raysect/core/math/sampler/{solidangle,surface3d,
targeted}.pyx. The reference samplers are stateful objects drawing one
sample per call from the global RNG; here each sampler is a thin class over
the batched primitives in core.math.random — ``sample(key, n)`` returns n
samples at once, ``pdf(directions)`` evaluates densities, and
``samples_with_pdfs`` mirrors the reference's paired API
(solidangle.pyx:42-147). Everything is jnp-traceable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import batch as vmath
from .. import random as vrand

__all__ = [
    "SolidAngleSampler", "SphereSampler", "HemisphereUniformSampler",
    "HemisphereCosineSampler", "ConeUniformSampler",
    "DiskSampler3D", "RectangleSampler3D", "TriangleSampler3D",
    "TargetedHemisphereSampler", "TargetedSphereSampler",
]

_PI = jnp.pi


class SolidAngleSampler:
    """Direction-distribution base (solidangle.pyx:42): ``sample``/``pdf``/
    ``samples_with_pdfs``."""

    def sample(self, key, n):
        """n direction samples [n,3] (local +z frame)."""
        raise NotImplementedError

    def pdf(self, directions):
        """Probability density per direction [...,3] -> [...]."""
        raise NotImplementedError

    def samples_with_pdfs(self, key, n):
        d = self.sample(key, n)
        return d, self.pdf(d)

    def __call__(self, key, n, pdf=False):
        return self.samples_with_pdfs(key, n) if pdf else self.sample(key, n)


class SphereSampler(SolidAngleSampler):
    """Uniform over the full sphere (solidangle.pyx:149)."""

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.vector_sphere(u[:, 0], u[:, 1])

    def pdf(self, directions):
        return jnp.full(directions.shape[:-1], 1.0 / (4.0 * _PI))


class HemisphereUniformSampler(SolidAngleSampler):
    """Uniform over the +z hemisphere (solidangle.pyx:176)."""

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.vector_hemisphere_uniform(u[:, 0], u[:, 1])

    def pdf(self, directions):
        up = directions[..., 2] >= 0.0
        return jnp.where(up, 1.0 / (2.0 * _PI), 0.0)


class HemisphereCosineSampler(SolidAngleSampler):
    """Cosine-weighted +z hemisphere (solidangle.pyx:208)."""

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.vector_hemisphere_cosine(u[:, 0], u[:, 1])

    def pdf(self, directions):
        z = directions[..., 2]
        return jnp.where(z >= 0.0, z / _PI, 0.0)


class ConeUniformSampler(SolidAngleSampler):
    """Uniform in a cone of half-angle ``angle`` degrees about +z
    (solidangle.pyx:240)."""

    def __init__(self, angle=45.0):
        if not 0 < angle <= 90.0:
            raise ValueError("The cone angle must lie in (0, 90] degrees.")
        self.angle = float(angle)
        self._cos_max = float(jnp.cos(jnp.deg2rad(angle)))

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.vector_cone_uniform(u[:, 0], u[:, 1], self._cos_max)

    def pdf(self, directions):
        inside = directions[..., 2] >= self._cos_max
        solid_angle = 2.0 * _PI * (1.0 - self._cos_max)
        return jnp.where(inside, 1.0 / solid_angle, 0.0)


# --- surface point samplers (surface3d.pyx) -----------------------------------------


class _SurfaceSampler3D:
    """Point-distribution base: ``sample(key, n)`` -> points [n,3] with
    ``area`` for pdf = 1/area (surface3d.pyx:38)."""

    area = None

    def sample(self, key, n):
        raise NotImplementedError

    def pdf(self, points=None, n=1):
        return jnp.full((n,) if points is None else points.shape[:-1], 1.0 / self.area)

    def samples_with_pdfs(self, key, n):
        p = self.sample(key, n)
        return p, self.pdf(p)

    def __call__(self, key, n, pdf=False):
        return self.samples_with_pdfs(key, n) if pdf else self.sample(key, n)


class DiskSampler3D(_SurfaceSampler3D):
    """Uniform over a disk in the z=0 plane (surface3d.pyx:136)."""

    def __init__(self, radius=1.0):
        if radius <= 0:
            raise ValueError("radius must be positive.")
        self.radius = float(radius)
        self.area = _PI * radius * radius

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.point_disk(u[:, 0], u[:, 1], self.radius)


class RectangleSampler3D(_SurfaceSampler3D):
    """Uniform over a centred rectangle in the z=0 plane (surface3d.pyx:169)."""

    def __init__(self, width=1.0, height=1.0):
        if width <= 0 or height <= 0:
            raise ValueError("width and height must be positive.")
        self.width = float(width)
        self.height = float(height)
        self.area = width * height

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.point_rectangle(u[:, 0], u[:, 1], self.width, self.height)


class TriangleSampler3D(_SurfaceSampler3D):
    """Uniform over a 3D triangle (surface3d.pyx:205)."""

    def __init__(self, v1, v2, v3):
        def as_arr(v):
            if hasattr(v, "x"):
                return jnp.asarray([v.x, v.y, v.z])
            return jnp.asarray(list(v), jnp.float32)

        self.v1 = as_arr(v1)
        self.v2 = as_arr(v2)
        self.v3 = as_arr(v3)
        self.area = float(
            0.5 * jnp.linalg.norm(jnp.cross(self.v2 - self.v1, self.v3 - self.v1))
        )

    def sample(self, key, n):
        u = jax.random.uniform(key, (n, 2))
        return vrand.point_triangle(u[:, 0], u[:, 1], self.v1, self.v2, self.v3)


# --- targeted samplers (targeted.pyx:41-440) ----------------------------------------


class _TargetedSampler(SolidAngleSampler):
    """Mixture of cone samplers aimed at weighted target spheres plus a
    fallback ambient distribution (targeted.pyx:41: CDF over targets, cone
    sampling, mixture pdf). Targets are (centre[3], radius, weight) tuples;
    the origin is fixed per sampler instance (the reference passes it per
    call — vectorise by constructing per batch)."""

    def __init__(self, targets, origin=(0.0, 0.0, 0.0)):
        import numpy as np

        if not targets:
            raise ValueError("At least one target sphere is required.")
        centres, radii, weights = [], [], []
        for centre, radius, weight in targets:
            c = [centre.x, centre.y, centre.z] if hasattr(centre, "x") else list(centre)
            if radius <= 0:
                raise ValueError("Target sphere radius must be positive.")
            if weight <= 0:
                raise ValueError("Target weight must be positive.")
            centres.append(c)
            radii.append(radius)
            weights.append(weight)
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        self.origin = jnp.asarray(
            [origin.x, origin.y, origin.z] if hasattr(origin, "x") else list(origin)
        )
        self._centre = jnp.asarray(centres)
        self._radius = jnp.asarray(radii)
        self._weight = jnp.asarray(w)
        self._cdf = jnp.asarray(np.cumsum(w))

    def _cones(self):
        to_c = self._centre - self.origin[None, :]
        dist = jnp.sqrt(jnp.sum(to_c * to_c, axis=-1) + 1e-30)
        axis = to_c / dist[:, None]
        sin2 = jnp.clip((self._radius / dist) ** 2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.clip(1.0 - sin2, 0.0, 1.0))
        cos_max = jnp.where(dist <= self._radius, -1.0, cos_max)
        return axis, cos_max

    def _ambient_sample(self, u1, u2):
        raise NotImplementedError

    def _ambient_pdf(self, directions):
        raise NotImplementedError

    # fraction of samples sent to targets vs ambient
    targeted_path_prob = 0.9

    def sample(self, key, n):
        ku, kc = jax.random.split(key)
        u = jax.random.uniform(ku, (n, 4))
        axis, cos_max = self._cones()
        idx = jnp.clip(
            jnp.searchsorted(self._cdf, u[:, 0], side="left"), 0, self._cdf.shape[0] - 1
        )
        ax = axis[idx]
        cm = cos_max[idx]
        local = vrand.vector_cone_uniform(u[:, 1], u[:, 2], cm)
        t, b, nrm = vmath.make_frame(ax)
        cone_dir = vmath.from_frame(local, t, b, nrm)
        amb = self._ambient_sample(u[:, 1], u[:, 2])
        pick_cone = u[:, 3] < self.targeted_path_prob
        return jnp.where(pick_cone[:, None], cone_dir, amb)

    def pdf(self, directions):
        axis, cos_max = self._cones()
        cos_to = jnp.sum(directions[..., None, :] * axis, axis=-1)  # [..., T]
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        in_cone = cos_to >= cos_max
        cone_pdf = jnp.where(in_cone, 1.0 / jnp.maximum(solid_angle, 1e-12), 0.0)
        mix = jnp.sum(self._weight * cone_pdf, axis=-1)
        p = self.targeted_path_prob
        return p * mix + (1.0 - p) * self._ambient_pdf(directions)


class TargetedHemisphereSampler(_TargetedSampler):
    """Targeted sampling over the +z hemisphere (targeted.pyx:251):
    ambient fallback is cosine-weighted; directions below the horizon get
    zero pdf."""

    def _ambient_sample(self, u1, u2):
        return vrand.vector_hemisphere_cosine(u1, u2)

    def _ambient_pdf(self, directions):
        z = directions[..., 2]
        return jnp.where(z >= 0.0, z / _PI, 0.0)

    def pdf(self, directions):
        base = super().pdf(directions)
        return jnp.where(directions[..., 2] >= 0.0, base, 0.0)


class TargetedSphereSampler(_TargetedSampler):
    """Targeted sampling over the full sphere (targeted.pyx:392): ambient
    fallback is the uniform sphere."""

    def _ambient_sample(self, u1, u2):
        return vrand.vector_sphere(u1, u2)

    def _ambient_pdf(self, directions):
        return jnp.full(directions.shape[:-1], 1.0 / (4.0 * _PI))
