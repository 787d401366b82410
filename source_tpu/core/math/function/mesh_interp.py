"""Unstructured-mesh interpolators (triangle / tetrahedral).

Counterparts of the reference's mesh interpolators
(raysect/core/math/function/float/function2d/interpolate/interpolator2dmesh.pyx:40
``Interpolator2DMesh`` — barycentric interpolation over a triangle mesh with
kd-tree point location; discrete2dmesh.pyx:39 ``Discrete2DMesh``;
function3d/.../discrete3dmesh.pyx:39 ``Discrete3DMesh`` tetrahedral).

Design: instead of a per-query kd-tree walk, point location is a
host-built uniform-grid bin structure — each query hashes to a grid cell and
tests that cell's fixed-size candidate list (barycentric containment), a
dense gather+mask computation that vmaps. Grid resolution ~sqrt(T) keeps the
candidate lists short for well-shaped meshes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import Function2D, Function3D

__all__ = ["Interpolator2DMesh", "Discrete2DMesh", "Discrete3DMesh"]


def _build_grid2d(vertices, triangles, cells_hint=None):
    """Host: bin triangles into a uniform grid. Returns (origin, inv_cell,
    shape, cand[cells, K] padded with -1)."""
    tri_pts = vertices[triangles]  # [T,3,2]
    lo = tri_pts.min(axis=(0, 1))
    hi = tri_pts.max(axis=(0, 1))
    span = np.maximum(hi - lo, 1e-12)
    T = len(triangles)
    res = cells_hint or max(1, int(np.sqrt(T / 2)))
    shape = (res, res)
    cell = span / np.asarray(shape)
    bins = [[] for _ in range(res * res)]
    t_lo = tri_pts.min(axis=1)
    t_hi = tri_pts.max(axis=1)
    for t in range(T):
        i0 = np.clip(((t_lo[t] - lo) / cell).astype(int), 0, res - 1)
        i1 = np.clip(((t_hi[t] - lo) / cell).astype(int), 0, res - 1)
        for ix in range(i0[0], i1[0] + 1):
            for iy in range(i0[1], i1[1] + 1):
                bins[ix * res + iy].append(t)
    K = max(1, max(len(b) for b in bins))
    cand = np.full((res * res, K), -1, np.int32)
    for c, b in enumerate(bins):
        cand[c, : len(b)] = b
    return lo, 1.0 / cell, shape, cand


class _TriMeshBase:
    """Shared triangle-mesh location machinery."""

    def __init__(self, vertex_coords, triangles, limit, default_value):
        v = np.asarray(vertex_coords, np.float64)
        t = np.asarray(triangles, np.int32)
        if v.ndim != 2 or v.shape[1] != 2:
            raise ValueError("vertex_coords must be [V,2].")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError("triangles must be [T,3].")
        self.limit = bool(limit)
        self.default_value = float(default_value)
        lo, inv_cell, shape, cand = _build_grid2d(v, t)
        self._v = jnp.asarray(v)
        self._t = jnp.asarray(t)
        self._grid_lo = jnp.asarray(lo)
        self._grid_inv = jnp.asarray(inv_cell)
        self._grid_shape = shape
        self._cand = jnp.asarray(cand)

    def _locate(self, x, y):
        """Containing triangle per query (-1 outside) + barycentrics."""
        q = jnp.stack([jnp.asarray(x), jnp.asarray(y)], axis=-1)
        cell = jnp.floor((q - self._grid_lo) * self._grid_inv).astype(jnp.int32)
        rx, ry = self._grid_shape
        outside_grid = (
            (cell[..., 0] < 0) | (cell[..., 0] >= rx)
            | (cell[..., 1] < 0) | (cell[..., 1] >= ry)
        )
        cidx = jnp.clip(cell[..., 0], 0, rx - 1) * ry + jnp.clip(cell[..., 1], 0, ry - 1)
        cand = self._cand[cidx]  # [..., K]
        tri = self._t[jnp.clip(cand, 0, self._t.shape[0] - 1)]  # [..., K, 3]
        p0 = self._v[tri[..., 0]]
        p1 = self._v[tri[..., 1]]
        p2 = self._v[tri[..., 2]]
        # barycentric coords (triangle.pyx:104 semantics)
        d = q[..., None, :]
        v0 = p1 - p0
        v1 = p2 - p0
        v2 = d - p0
        den = v0[..., 0] * v1[..., 1] - v1[..., 0] * v0[..., 1]
        ok = jnp.abs(den) > 1e-300
        inv = jnp.where(ok, 1.0 / jnp.where(ok, den, 1.0), 0.0)
        b1 = (v2[..., 0] * v1[..., 1] - v1[..., 0] * v2[..., 1]) * inv
        b2 = (v0[..., 0] * v2[..., 1] - v2[..., 0] * v0[..., 1]) * inv
        b0 = 1.0 - b1 - b2
        tol = 1e-9
        inside = (
            (cand >= 0) & ok
            & (b0 >= -tol) & (b1 >= -tol) & (b2 >= -tol)
            & ~outside_grid[..., None]
        )
        first = jnp.argmax(inside, axis=-1)
        found = jnp.take_along_axis(inside, first[..., None], axis=-1)[..., 0]
        tri_id = jnp.take_along_axis(cand, first[..., None], axis=-1)[..., 0]
        tri_id = jnp.where(found, tri_id, -1)
        bary = jnp.stack(
            [
                jnp.take_along_axis(b0, first[..., None], axis=-1)[..., 0],
                jnp.take_along_axis(b1, first[..., None], axis=-1)[..., 0],
                jnp.take_along_axis(b2, first[..., None], axis=-1)[..., 0],
            ],
            axis=-1,
        )
        return tri_id, bary


class Interpolator2DMesh(Function2D, _TriMeshBase):
    """Barycentric interpolation of per-vertex data over a triangle mesh
    (interpolator2dmesh.pyx:40). Outside the mesh: default_value if
    ``limit`` is False, else NaN (the reference raises)."""

    def __init__(self, vertex_coords, vertex_data, triangles, limit=True,
                 default_value=0.0):
        _TriMeshBase.__init__(self, vertex_coords, triangles, limit, default_value)
        data = np.asarray(vertex_data, np.float64)
        if data.shape[0] != np.asarray(vertex_coords).shape[0]:
            raise ValueError("vertex_data must match vertex_coords length.")
        self._data = jnp.asarray(data)

    def __call__(self, x, y):
        tri_id, bary = self._locate(x, y)
        tri = self._t[jnp.clip(tri_id, 0, self._t.shape[0] - 1)]
        val = (
            bary[..., 0] * self._data[tri[..., 0]]
            + bary[..., 1] * self._data[tri[..., 1]]
            + bary[..., 2] * self._data[tri[..., 2]]
        )
        missing = jnp.nan if self.limit else self.default_value
        return jnp.where(tri_id >= 0, val, missing)


class Discrete2DMesh(Function2D, _TriMeshBase):
    """Per-triangle constant values over a triangle mesh
    (discrete2dmesh.pyx:39)."""

    def __init__(self, vertex_coords, triangles, triangle_data, limit=True,
                 default_value=0.0):
        _TriMeshBase.__init__(self, vertex_coords, triangles, limit, default_value)
        data = np.asarray(triangle_data, np.float64)
        if data.shape[0] != np.asarray(triangles).shape[0]:
            raise ValueError("triangle_data must match triangles length.")
        self._data = jnp.asarray(data)

    def __call__(self, x, y):
        tri_id, _ = self._locate(x, y)
        val = self._data[jnp.clip(tri_id, 0, self._data.shape[0] - 1)]
        missing = jnp.nan if self.limit else self.default_value
        return jnp.where(tri_id >= 0, val, missing)


class Discrete3DMesh(Function3D):
    """Per-tetrahedron constant values over a tet mesh
    (discrete3dmesh.pyx:39). Point location tests barycentric containment of
    grid-binned candidate tetrahedra."""

    def __init__(self, vertex_coords, tetrahedra, tetrahedra_data, limit=True,
                 default_value=0.0):
        v = np.asarray(vertex_coords, np.float64)
        t = np.asarray(tetrahedra, np.int32)
        if v.ndim != 2 or v.shape[1] != 3:
            raise ValueError("vertex_coords must be [V,3].")
        if t.ndim != 2 or t.shape[1] != 4:
            raise ValueError("tetrahedra must be [T,4].")
        data = np.asarray(tetrahedra_data, np.float64)
        self.limit = bool(limit)
        self.default_value = float(default_value)

        tet_pts = v[t]  # [T,4,3]
        lo = tet_pts.min(axis=(0, 1))
        hi = tet_pts.max(axis=(0, 1))
        span = np.maximum(hi - lo, 1e-12)
        T = len(t)
        res = max(1, int(round((T / 4) ** (1.0 / 3.0))))
        cell = span / res
        bins = [[] for _ in range(res ** 3)]
        t_lo = tet_pts.min(axis=1)
        t_hi = tet_pts.max(axis=1)
        for k in range(T):
            i0 = np.clip(((t_lo[k] - lo) / cell).astype(int), 0, res - 1)
            i1 = np.clip(((t_hi[k] - lo) / cell).astype(int), 0, res - 1)
            for ix in range(i0[0], i1[0] + 1):
                for iy in range(i0[1], i1[1] + 1):
                    for iz in range(i0[2], i1[2] + 1):
                        bins[(ix * res + iy) * res + iz].append(k)
        K = max(1, max(len(b) for b in bins))
        cand = np.full((res ** 3, K), -1, np.int32)
        for c, b in enumerate(bins):
            cand[c, : len(b)] = b

        self._v = jnp.asarray(v)
        self._t = jnp.asarray(t)
        self._data = jnp.asarray(data)
        self._grid_lo = jnp.asarray(lo)
        self._grid_inv = jnp.asarray(1.0 / cell)
        self._res = res
        self._cand = jnp.asarray(cand)

    def __call__(self, x, y, z):
        q = jnp.stack([jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)], axis=-1)
        res = self._res
        cell = jnp.floor((q - self._grid_lo) * self._grid_inv).astype(jnp.int32)
        outside_grid = jnp.any((cell < 0) | (cell >= res), axis=-1)
        cc = jnp.clip(cell, 0, res - 1)
        cidx = (cc[..., 0] * res + cc[..., 1]) * res + cc[..., 2]
        cand = self._cand[cidx]  # [..., K]
        tet = self._t[jnp.clip(cand, 0, self._t.shape[0] - 1)]  # [..., K, 4]
        p0 = self._v[tet[..., 0]]
        p1 = self._v[tet[..., 1]]
        p2 = self._v[tet[..., 2]]
        p3 = self._v[tet[..., 3]]
        # barycentric via 3x3 solve (tetrahedra.pyx:129 semantics)
        d = q[..., None, :] - p0
        e1 = p1 - p0
        e2 = p2 - p0
        e3 = p3 - p0
        det = jnp.sum(e1 * jnp.cross(e2, e3), axis=-1)
        ok = jnp.abs(det) > 1e-300
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        b1 = jnp.sum(d * jnp.cross(e2, e3), axis=-1) * inv
        b2 = jnp.sum(e1 * jnp.cross(d, e3), axis=-1) * inv
        b3 = jnp.sum(e1 * jnp.cross(e2, d), axis=-1) * inv
        b0 = 1.0 - b1 - b2 - b3
        tol = 1e-9
        inside = (
            (cand >= 0) & ok
            & (b0 >= -tol) & (b1 >= -tol) & (b2 >= -tol) & (b3 >= -tol)
            & ~outside_grid[..., None]
        )
        first = jnp.argmax(inside, axis=-1)
        found = jnp.take_along_axis(inside, first[..., None], axis=-1)[..., 0]
        tet_id = jnp.take_along_axis(cand, first[..., None], axis=-1)[..., 0]
        val = self._data[jnp.clip(tet_id, 0, self._data.shape[0] - 1)]
        missing = jnp.nan if self.limit else self.default_value
        return jnp.where(found, val, missing)
