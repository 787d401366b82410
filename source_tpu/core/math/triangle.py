"""Batched triangle / tetrahedra / polygon predicates.

Counterparts of the reference's nogil scalar geometry utilities
(raysect/core/math/cython/triangle.pyx:35 ``inside_triangle``, :104
``barycentric_coords``, :144/:159 barycentric predicates/interpolation;
cython/tetrahedra.pyx:35 ``inside_tetrahedra``, :129
``barycentric_coords_tetra``; cython/utility.pyx:752 ``winding2d``, :786
``point_inside_polygon``). The reference evaluates one point at a time in
C; these accept arbitrary leading batch dimensions and trace to fused XLA,
so the same predicates run wide inside jitted kernels.

All functions work with either numpy or jax arrays (jnp ops on numpy input
return jax arrays; wrap with ``np.asarray`` if host values are needed).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "barycentric_coords", "barycentric_inside_triangle",
    "barycentric_interpolation", "inside_triangle",
    "barycentric_coords_tetra", "barycentric_inside_tetrahedra",
    "barycentric_interpolation_tetra", "inside_tetrahedra",
    "winding2d", "point_inside_polygon",
]


def barycentric_coords(v1, v2, v3, p):
    """Barycentric coordinates (alpha, beta, gamma) of 2D points ``p``
    w.r.t. triangle (v1, v2, v3) (triangle.pyx:104). Inputs [..., 2]."""
    x1, y1 = v1[..., 0], v1[..., 1]
    x2, y2 = v2[..., 0], v2[..., 1]
    x3, y3 = v3[..., 0], v3[..., 1]
    x, y = p[..., 0], p[..., 1]
    det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
    norm = jnp.where(jnp.abs(det) > 0, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
    alpha = norm * ((y2 - y3) * (x - x3) + (x3 - x2) * (y - y3))
    beta = norm * ((y3 - y1) * (x - x3) + (x1 - x3) * (y - y3))
    gamma = 1.0 - alpha - beta
    return alpha, beta, gamma


def barycentric_inside_triangle(alpha, beta, gamma):
    """True where the barycentric point lies inside the triangle
    (triangle.pyx:144 — boundary inclusive)."""
    return (alpha >= 0) & (beta >= 0) & (gamma >= 0)


def barycentric_interpolation(alpha, beta, gamma, va, vb, vc):
    """Interpolate vertex values by barycentric weights (triangle.pyx:159)."""
    return alpha * va + beta * vb + gamma * vc


def inside_triangle(v1, v2, v3, p):
    """Point-in-2D-triangle test (triangle.pyx:35). Inputs [..., 2]."""
    return barycentric_inside_triangle(*barycentric_coords(v1, v2, v3, p))


def barycentric_coords_tetra(v1, v2, v3, v4, p):
    """Barycentric coordinates (alpha, beta, gamma, delta) of 3D points
    w.r.t. tetrahedron (v1..v4) (tetrahedra.pyx:129). Inputs [..., 3]."""
    a = v1 - v4
    b = v2 - v4
    c = v3 - v4
    r = p - v4
    # Cramer's rule on the 3x3 system [a b c] @ (alpha,beta,gamma) = r
    def det3(u, v, w):
        return (
            u[..., 0] * (v[..., 1] * w[..., 2] - v[..., 2] * w[..., 1])
            - u[..., 1] * (v[..., 0] * w[..., 2] - v[..., 2] * w[..., 0])
            + u[..., 2] * (v[..., 0] * w[..., 1] - v[..., 1] * w[..., 0])
        )
    d = det3(a, b, c)
    inv = jnp.where(jnp.abs(d) > 0, 1.0 / jnp.where(d != 0, d, 1.0), 0.0)
    alpha = det3(r, b, c) * inv
    beta = det3(a, r, c) * inv
    gamma = det3(a, b, r) * inv
    delta = 1.0 - alpha - beta - gamma
    return alpha, beta, gamma, delta


def barycentric_inside_tetrahedra(alpha, beta, gamma, delta):
    """True where the barycentric point lies inside the tetrahedron
    (tetrahedra.pyx:197)."""
    return (alpha >= 0) & (beta >= 0) & (gamma >= 0) & (delta >= 0)


def barycentric_interpolation_tetra(alpha, beta, gamma, delta, va, vb, vc, vd):
    """Interpolate vertex values by barycentric weights (tetrahedra.pyx:213)."""
    return alpha * va + beta * vb + gamma * vc + delta * vd


def inside_tetrahedra(v1, v2, v3, v4, p):
    """Point-in-tetrahedron test (tetrahedra.pyx:35). Inputs [..., 3]."""
    return barycentric_inside_tetrahedra(*barycentric_coords_tetra(v1, v2, v3, v4, p))


def winding2d(vertices):
    """True when a closed 2D polygon [..., N, 2] is clockwise-wound
    (utility.pyx:752 — sign of the summed edge cross products)."""
    v = jnp.asarray(vertices)
    nxt = jnp.roll(v, -1, axis=-2)
    area2 = jnp.sum(
        (nxt[..., 0] - v[..., 0]) * (nxt[..., 1] + v[..., 1]), axis=-1
    )
    return area2 > 0


def point_inside_polygon(vertices, ptx, pty):
    """Even-odd point-in-polygon test for a simple 2D polygon
    (utility.pyx:786 crossing-count algorithm). ``vertices`` [N, 2];
    ptx/pty scalars or broadcastable batch arrays."""
    v = jnp.asarray(vertices)
    x1, y1 = v[:, 0], v[:, 1]
    x2 = jnp.roll(x1, -1)
    y2 = jnp.roll(y1, -1)
    px = jnp.asarray(ptx)[..., None]
    py = jnp.asarray(pty)[..., None]
    straddle = (y1 > py) != (y2 > py)
    dy = jnp.where(y2 != y1, y2 - y1, 1.0)
    x_cross = x1 + (py - y1) * (x2 - x1) / dy
    crossings = jnp.sum(straddle & (px < x_cross), axis=-1)
    return crossings % 2 == 1
