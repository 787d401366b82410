"""Device-side batched vector/transform math.

This module is the vectorised replacement for the reference's per-object
Cython vector math (raysect/core/math/{vector,point,normal,affinematrix}.pyx):
every operation acts on arrays of shape ``[..., 3]`` (or ``[..., 4, 4]`` for
transforms) and is fully traceable under ``jax.jit`` / ``vmap`` / ``grad``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot",
    "cross",
    "length",
    "normalise",
    "lerp",
    "orthogonal",
    "select_rows",
    "transform_point",
    "transform_vector",
    "transform_normal",
    "make_frame",
    "to_frame",
    "from_frame",
    "reflect",
]


def safe_sqrt(x, min_val=0.0):
    """sqrt with a NaN-free backward at x <= min_val (double-where pattern).

    Reverse-mode through ``sqrt(max(x, 0))`` produces inf/NaN cotangents on
    clamped lanes; masking the *input* first keeps gradients finite, which
    the differentiable render path requires everywhere a discriminant or
    norm can touch zero.
    """
    ok = x > min_val
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)


def safe_div(a, b, eps=1e-12):
    """a / b with a NaN-free backward when |b| <= eps (result 0 there)."""
    ok = jnp.abs(b) > eps
    return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)


def safe_pow(base, exp):
    """base ** exp with NaN-free backward at base <= 0 (result 0 there)."""
    ok = base > 0.0
    return jnp.where(ok, jnp.where(ok, base, 1.0) ** exp, 0.0)


SELECT_ROWS_MAX = 64
# above this row count the one-hot [N, L] operand outweighs the gather cost
SELECT_ROWS_ONEHOT_MAX = 4096
# cap on the one-hot operand's bytes (N * L * 4); above it the gather wins
# on memory traffic even when L alone is in the contraction's band
SELECT_ROWS_ONEHOT_MAX_BYTES = 768 * 1024 * 1024


def select_rows(table, idx, limit=SELECT_ROWS_MAX):
    """``table[idx]`` for a small first axis, as a one-hot masked select.

    Scene tables (leaf transforms, material spectra/params) have tiny
    leading axes, so the hot paths use L static where-passes instead of a
    dynamic row gather (the crossover is not measured on the H100 yet).
    Index values outside
    [0, L) produce zero rows. Falls back to a plain gather above ``limit``
    rows. Differentiable w.r.t. ``table`` (masked-sum backward).
    """
    L = table.shape[0]
    if L > SELECT_ROWS_ONEHOT_MAX:
        return table[idx]
    if L > limit:
        # the [N, L] one-hot operand must also stay within a sane memory
        # footprint: near the L cap with flagship-sized batches the operand
        # alone would spike ~2 GB per call, so large N*L products fall back
        # to the gather
        n_idx = 1
        for s in idx.shape:
            n_idx *= int(s)
        if n_idx * L * 4 > SELECT_ROWS_ONEHOT_MAX_BYTES:
            return table[idx]
        # mid-size tables: one-hot CONTRACTION. Each output row is an
        # exact copy (exactly one nonzero per one-hot row, f32 HIGHEST
        # precision, never TF32) and the backward is the transposed
        # matmul (onehot^T @ g).
        import jax as _jax

        flat = table.reshape(L, -1)
        int_table = not jnp.issubdtype(table.dtype, jnp.floating)
        if int_table:  # exact in f32 for indices/ids < 2^24
            flat = flat.astype(jnp.float32)
        idx_flat = idx.reshape(-1)
        onehot = (idx_flat[:, None] == jnp.arange(L)[None, :]).astype(flat.dtype)
        out = _jax.lax.dot_general(
            onehot, flat, (((1,), (0,)), ((), ())),
            precision=_jax.lax.Precision.HIGHEST,
        )
        if int_table:
            out = jnp.round(out).astype(table.dtype)
        return out.reshape(idx.shape + table.shape[1:])
    m_shape = idx.shape + (1,) * (table.ndim - 1)
    out = jnp.zeros(idx.shape + table.shape[1:], table.dtype)
    for l in range(L):
        out = jnp.where((idx == l).reshape(m_shape), table[l], out)
    return out


def dot(a, b):
    """Batched 3-vector dot product: [...,3] x [...,3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched 3-vector cross product."""
    return jnp.cross(a, b)


def length(v):
    """Batched vector length (NaN-free backward at zero length)."""
    return safe_sqrt(jnp.sum(v * v, axis=-1))


def normalise(v, eps=1e-24):
    """Batched safe normalise (zero vectors map to zero, finite grads)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = n2 > eps
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)
    return v * inv


def lerp(a, b, t):
    return a + (b - a) * t


def orthogonal(v):
    """An arbitrary unit vector orthogonal to v (vector.pyx orthogonal()).

    Branchless: choose the smallest-magnitude component's axis.
    """
    ax = jnp.abs(v)
    # one-hot of argmin(|v|) from comparisons instead of an eye[argmin]
    # row gather; cumsum tie-breaks toward the first axis
    is_min = ax <= jnp.min(ax, axis=-1, keepdims=True)
    axis = (is_min & (jnp.cumsum(is_min, axis=-1) == 1)).astype(v.dtype)
    return normalise(jnp.cross(v, axis))


def _mat3_apply(m3, v):
    """[..., 3, 3] x [..., 3] -> [..., 3] as explicit multiply-adds.

    Written without einsum/dot so XLA keeps it elementwise in full f32 —
    a matrix unit's reduced default precision (TF32 on the GPU, ~1e-3
    relative) is not acceptable for ray geometry (it would break epsilon
    offsets).
    """
    x = v[..., 0:1]
    y = v[..., 1:2]
    z = v[..., 2:3]
    return m3[..., :, 0] * x + m3[..., :, 1] * y + m3[..., :, 2] * z


def transform_point(m, p):
    """Affine-transform points. m: [...,4,4], p: [...,3] -> [...,3]."""
    return _mat3_apply(m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m, v):
    """Transform vectors (no translation)."""
    return _mat3_apply(m[..., :3, :3], v)


def transform_normal(m_inv, n):
    """Transform normals with the transpose of the INVERSE matrix
    (normal.pyx:38 semantics). ``m_inv`` must be the inverse of the
    coordinate transform."""
    # transpose on the 3x3 block
    m3t = jnp.swapaxes(m_inv[..., :3, :3], -1, -2)
    return _mat3_apply(m3t, n)


def make_frame(normal):
    """Build an orthonormal (tangent, bitangent, normal) frame per normal.

    Equivalent to the reference's ``_generate_surface_transforms``
    (optical/material/material.pyx:393-422). Returns (t, b, n) each [...,3],
    using the branchless Duff et al. construction (differentiable, no
    divergence).
    """
    n = normal
    # sign threshold tolerates fp-noise zeros (a transform-produced normal
    # carries nz ~ +-1e-7 where an analytically exact path gives +-0.0; the
    # Duff construction is equally valid for either s as long as s+nz stays
    # away from 0, so snapping the band to +1 keeps the CHOICE of frame
    # deterministic across float routes)
    s = jnp.where(n[..., 2] >= -1e-6, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt, n


def to_frame(v, t, b, n):
    """World->surface frame: components of v along (t, b, n)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def from_frame(v, t, b, n):
    """Surface->world frame."""
    return (
        v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n
    )


def reflect(d, n):
    """Mirror direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n
