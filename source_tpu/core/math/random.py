"""Counter-based random sampling for the wavefront tracer.

Vectorised replacement for the reference's global MT19937-64 RNG
(raysect/core/math/random.pyx:31-308) and its per-worker re-seeding
(core/workflow.py:305). Instead of a mutable global stream, every ray derives
a deterministic, decorrelated `jax.random` key by folding in
(device, pixel, sample, bounce) counters — the JAX-idiomatic equivalent.

Vector samplers mirror random.pyx's ``vector_sphere/vector_hemisphere_uniform/
vector_hemisphere_cosine/vector_cone_uniform`` plus the pdf conventions of the
SolidAngleSampler classes (core/math/sampler/solidangle.pyx:42-283).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = [
    "ray_keys",
    "uniform",
    "normal",
    "probability",
    "vector_sphere",
    "vector_hemisphere_uniform",
    "vector_hemisphere_cosine",
    "vector_cone_uniform",
    "vector_cone_cosine",
    "point_disk",
    "point_square",
    "point_rectangle",
    "point_triangle",
    "pdf_sphere",
    "pdf_hemisphere_uniform",
    "pdf_hemisphere_cosine",
    "pdf_cone_uniform",
]

_2PI = 2.0 * math.pi


def _safe_sqrt(x):
    ok = x > 0.0
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)
_R4PI = 1.0 / (4.0 * math.pi)
_R2PI = 1.0 / (2.0 * math.pi)
_RPI = 1.0 / math.pi


def ray_keys(base_key, ray_ids, bounce):
    """Derive one key per ray from a base key, the ray's global id and the
    bounce index. ``ray_ids`` is int32 [...]; returns keys with leading shape
    matching ray_ids."""
    k = jax.random.fold_in(base_key, bounce)
    return jax.vmap(lambda i: jax.random.fold_in(k, i))(ray_ids)


def uniform(key, shape=()):
    """U[0, 1) samples (random.pyx:247)."""
    return jax.random.uniform(key, shape)


def normal(key, mean=0.0, stddev=1.0, shape=()):
    """Gaussian samples (random.pyx:273)."""
    return mean + stddev * jax.random.normal(key, shape)


def probability(key, prob, shape=()):
    """True with probability prob (random.pyx:308)."""
    return jax.random.uniform(key, shape) < prob


# --- solid angle samplers ---------------------------------------------------
# All samplers take uniform pairs u1,u2 in [0,1) so callers control the
# underlying random bit generation (and the sampling stays differentiable
# w.r.t. nothing but the parameters).


def vector_sphere(u1, u2):
    """Uniform direction on the full sphere. pdf = 1/(4 pi)."""
    z = 1.0 - 2.0 * u1
    r = _safe_sqrt(1.0 - z * z)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def vector_hemisphere_uniform(u1, u2):
    """Uniform direction on +z hemisphere. pdf = 1/(2 pi)."""
    z = u1
    r = _safe_sqrt(1.0 - z * z)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def vector_hemisphere_cosine(u1, u2):
    """Cosine-weighted direction on +z hemisphere. pdf = cos(theta)/pi."""
    z2 = u1
    z = _safe_sqrt(z2)
    r = _safe_sqrt(1.0 - z2)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def vector_cone_uniform(u1, u2, cos_max):
    """Uniform direction in a cone of half-angle acos(cos_max) about +z.
    pdf = 1 / (2 pi (1 - cos_max)) (solidangle.pyx ConeUniformSampler:240)."""
    z = 1.0 - u1 * (1.0 - cos_max)
    r = _safe_sqrt(1.0 - z * z)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def vector_cone_cosine(u1, u2, cos_max):
    """Cosine-weighted direction in a cone about +z."""
    z2 = 1.0 - u1 * (1.0 - cos_max * cos_max)
    z = _safe_sqrt(z2)
    r = _safe_sqrt(1.0 - z2)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def pdf_sphere(d=None):
    return _R4PI


def pdf_hemisphere_uniform(d):
    """pdf for a +z-frame direction d [...,3]."""
    return jnp.where(d[..., 2] >= 0.0, _R2PI, 0.0)


def pdf_hemisphere_cosine(d):
    return jnp.maximum(d[..., 2], 0.0) * _RPI


def pdf_cone_uniform(d, cos_max):
    inside = d[..., 2] >= cos_max
    return jnp.where(inside, 1.0 / (_2PI * jnp.maximum(1.0 - cos_max, 1e-12)), 0.0)


# --- surface point samplers (sampler/surface3d.pyx) --------------------------


def point_disk(u1, u2, radius=1.0):
    """Uniform point on a disk in the z=0 plane (DiskSampler3D:136)."""
    r = radius * jnp.sqrt(u1)
    phi = _2PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), jnp.zeros_like(r)], axis=-1)


def point_square(u1, u2, width=1.0):
    """Uniform point on an axis-aligned square centred at origin, z=0."""
    return jnp.stack(
        [(u1 - 0.5) * width, (u2 - 0.5) * width, jnp.zeros_like(u1)], axis=-1
    )


def point_rectangle(u1, u2, width, height):
    """Uniform point on a rectangle centred at origin, z=0
    (RectangleSampler3D:169)."""
    return jnp.stack(
        [(u1 - 0.5) * width, (u2 - 0.5) * height, jnp.zeros_like(u1)], axis=-1
    )


def point_triangle(u1, u2, v1, v2, v3):
    """Uniform point on triangle (v1,v2,v3) (TriangleSampler3D:205)."""
    su1 = jnp.sqrt(u1)
    b0 = 1.0 - su1
    b1 = u2 * su1
    b2 = 1.0 - b0 - b1
    return (
        b0[..., None] * v1 + b1[..., None] * v2 + b2[..., None] * v3
    )
