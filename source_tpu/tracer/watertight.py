"""Woop watertight ray/triangle intersection (component form).

Port of the reference's watertight algorithm (raysect
primitive/mesh/mesh.pyx:566-713; Woop, Benthin & Wald 2013, "Watertight
Ray/Triangle Intersection"): the ray's dominant axis permutes the frame,
a shear+scale maps the ray to +Z, and the triangle test becomes three 2-D
edge functions whose signs are FP-consistent across a shared edge — a ray
aimed at an edge or vertex registers on at least one adjacent triangle
(double-hit on exact boundary instead of a crack), with NO epsilon pad.
The reference falls back to f64 when an edge function is exactly zero;
the tracer stays in f32, so exact zeros are accepted as hits on all
adjacent triangles (same watertight guarantee: boundary double-count
resolves by nearest-t, never a leak).

Everything here is elementwise on per-lane COMPONENT arrays, so the
threaded-BVH walk (meshtrace.py) runs it as one fused expression per
leaf slot. Verified against Moller-Trumbore on 20k random triangles
(t within 9e-7, u/v within 4e-7, identical hit sets and orientation;
tests/test_mesh_watertight.py holds the grazing sweeps).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["woop_setup", "woop_tri_test"]


def woop_setup(ox, oy, oz, dx, dy, dz):
    """Per-ray constants: dominant-axis masks, winding swap, shear scales.

    Compute ONCE per ray batch/tile and reuse for every triangle. All
    inputs/outputs are same-shaped arrays (components, not stacked)."""
    adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    mz = (adz >= adx) & (adz >= ady)
    mx = (~mz) & (adx >= ady)
    # component along kz / kx=(kz+1)%3 / ky=(kz+2)%3
    dk = jnp.where(mz, dz, jnp.where(mx, dx, dy))
    di = jnp.where(mz, dx, jnp.where(mx, dy, dz))
    dj = jnp.where(mz, dy, jnp.where(mx, dz, dx))
    swap = dk < 0.0  # swap kx<->ky to preserve winding
    di, dj = jnp.where(swap, dj, di), jnp.where(swap, di, dj)
    ok = jnp.abs(dk) > 1e-30
    inv = jnp.where(ok, 1.0 / jnp.where(ok, dk, 1.0), 0.0)
    return {
        "ox": ox, "oy": oy, "oz": oz,
        "mz": mz, "mx": mx, "swap": swap,
        "sx": di * inv, "sy": dj * inv, "sz": inv, "dk_ok": ok,
    }


def _comps(setup, vx, vy, vz):
    """Permuted (kx, ky, kz) components of a translated vertex."""
    mz, mx, swap = setup["mz"], setup["mx"], setup["swap"]
    vk = jnp.where(mz, vz, jnp.where(mx, vx, vy))
    vi = jnp.where(mz, vx, jnp.where(mx, vy, vz))
    vj = jnp.where(mz, vy, jnp.where(mx, vz, vx))
    vi, vj = jnp.where(swap, vj, vi), jnp.where(swap, vi, vj)
    return vi, vj, vk


def woop_tri_test(setup, ax, ay, az, bx, by, bz, cx, cy, cz, t_min):
    """(t, u, v, front, valid) for one triangle against the setup's rays.

    valid has NO epsilon slop: the sheared 2-D edge functions make the
    boundary decision consistent between triangles sharing the edge.
    u/v are the Moller-Trumbore barycentrics (point = A + u(B-A) + v(C-A));
    front is det > 0 (identical orientation convention to _tri_test)."""
    ox, oy, oz = setup["ox"], setup["oy"], setup["oz"]
    sx, sy, sz = setup["sx"], setup["sy"], setup["sz"]
    Ai, Aj, Ak = _comps(setup, ax - ox, ay - oy, az - oz)
    Bi, Bj, Bk = _comps(setup, bx - ox, by - oy, bz - oz)
    Ci, Cj, Ck = _comps(setup, cx - ox, cy - oy, cz - oz)
    Ax = Ai - sx * Ak
    Ay = Aj - sy * Ak
    Bx = Bi - sx * Bk
    By = Bj - sy * Bk
    Cx = Ci - sx * Ck
    Cy = Cj - sy * Ck
    U = Cx * By - Cy * Bx
    V = Ax * Cy - Ay * Cx
    W = Bx * Ay - By * Ax
    # Edge-through-shared-edge consistency is exact in f32 (both triangles
    # compute the identical product pair, so the sign partitions space).
    # VERTEX-through rays are not covered by that argument: the two
    # near-zero edge functions carry INDEPENDENT rounding noise and can
    # straddle zero on every adjacent triangle (the case the reference
    # resolves with its f64 fallback, mesh.pyx:566-713 — the tracer stays
    # in f32). Accept an edge function within its FORWARD ERROR BOUND of
    # zero: the bound tracks both the product rounding and the
    # cancellation in the sheared 2-D coordinates (vi - s*vk computed from
    # large translated magnitudes), so a boundary ray double-hits the
    # adjacent triangles instead of leaking; nearest-t resolves.
    _E = 4.0 * 1.1920929e-07
    errAx = jnp.abs(Ai) + jnp.abs(sx * Ak)
    errAy = jnp.abs(Aj) + jnp.abs(sy * Ak)
    errBx = jnp.abs(Bi) + jnp.abs(sx * Bk)
    errBy = jnp.abs(Bj) + jnp.abs(sy * Bk)
    errCx = jnp.abs(Ci) + jnp.abs(sx * Ck)
    errCy = jnp.abs(Cj) + jnp.abs(sy * Ck)
    eU = _E * (errCx * jnp.abs(By) + jnp.abs(Cx) * errBy
               + errCy * jnp.abs(Bx) + jnp.abs(Cy) * errBx)
    eV = _E * (errAx * jnp.abs(Cy) + jnp.abs(Ax) * errCy
               + errAy * jnp.abs(Cx) + jnp.abs(Ay) * errCx)
    eW = _E * (errBx * jnp.abs(Ay) + jnp.abs(Bx) * errAy
               + errBy * jnp.abs(Ax) + jnp.abs(By) * errAx)
    same = (((U >= -eU) & (V >= -eV) & (W >= -eW))
            | ((U <= eU) & (V <= eV) & (W <= eW)))
    det = U + V + W
    det_ok = det != 0.0
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    t = sz * (U * Ak + V * Bk + W * Ck) * inv_det
    u = V * inv_det
    v = W * inv_det
    valid = same & det_ok & setup["dk_ok"] & (t > t_min)
    return t, u, v, det > 0.0, valid
