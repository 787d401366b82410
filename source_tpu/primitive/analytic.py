"""Batched analytic primitive intersection kernels (local space).

Vectorised replacement for the reference's per-object Cython ``hit()``
implementations (raysect/primitive/{sphere,box,cylinder,cone,parabola,
torus}.pyx). Each primitive type provides three *vectorized* functions
operating in the primitive's local frame:

  candidates_<type>(o, d, params) -> t[..., K]
      All boundary crossings of the closed solid along the ray, sorted
      ascending, +inf for unused slots. K = MAX_HITS = 4 (the torus quartic
      needs all four; convex solids use two).

  normal_<type>(p, params) -> n[..., 3]
      Outward local surface normal at a point on the surface.

  contains_<type>(p, params) -> bool[...]
      Point-in-solid test (reference contains() semantics).

Shapes: ``o``/``d``/``p`` are [..., 3]; ``params`` is [..., NP] broadcastable
against the leading dims. Everything is branchless jnp so the scene
intersector can evaluate whole (ray x leaf) blocks in one fused kernel.

Local-space conventions match the reference exactly:
  - sphere: radius, centred at origin                  (sphere.pyx:45)
  - box: axis-aligned [lower, upper]                   (box.pyx:56)
  - cylinder: radius, z in [0, height], capped         (cylinder.pyx:56)
  - cone: base radius at z=0, apex z=height, capped    (cone.pyx:50)
  - parabola: base radius at z=0, vertex z=height      (parabola.pyx:51)
  - torus: major/minor radii, axis +z                  (torus.pyx:46)

Param block layout (PARAM_BLOCK = 8 floats):
  sphere   [r]
  box      [lx, ly, lz, ux, uy, uz]
  cylinder [r, h]
  cone     [r, h]
  parabola [r, h]
  torus    [R, r]
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.math.polyroots import solve_quadratic, solve_quartic

__all__ = [
    "MAX_HITS",
    "PARAM_BLOCK",
    "TYPE_SPHERE",
    "TYPE_BOX",
    "TYPE_CYLINDER",
    "TYPE_CONE",
    "TYPE_PARABOLA",
    "TYPE_TORUS",
    "CANDIDATE_FNS",
    "NORMAL_FNS",
    "CONTAINS_FNS",
]

MAX_HITS = 4
PARAM_BLOCK = 8
_INF = jnp.inf

TYPE_SPHERE = 0
TYPE_BOX = 1
TYPE_CYLINDER = 2
TYPE_CONE = 3
TYPE_PARABOLA = 4
TYPE_TORUS = 5


def _pack2(t0, t1, v0, v1):
    """Pack two candidate hits into a sorted K=4 row."""
    a = jnp.where(v0, t0, _INF)
    b = jnp.where(v1, t1, _INF)
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    pad = jnp.full_like(lo, _INF)
    return jnp.stack([lo, hi, pad, pad], axis=-1)


# --- sphere -------------------------------------------------------------------


def candidates_sphere(o, d, params):
    r = params[..., 0]
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(o * d, axis=-1)
    c = jnp.sum(o * o, axis=-1) - r * r
    roots, valid = solve_quadratic(a, b, c)
    return _pack2(roots[..., 0], roots[..., 1], valid[..., 0], valid[..., 1])


def normal_sphere(p, params):
    r = jnp.maximum(params[..., 0:1], 1e-30)
    return p / r


def contains_sphere(p, params):
    r = params[..., 0]
    return jnp.sum(p * p, axis=-1) <= r * r


# --- box ----------------------------------------------------------------------


def candidates_box(o, d, params):
    lower = params[..., 0:3]
    upper = params[..., 3:6]
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, jnp.where(d >= 0, 1e-30, -1e-30))
    t0 = (lower - o) * inv
    t1 = (upper - o) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = tmax >= tmin
    return _pack2(tmin, tmax, hit, hit)


def normal_box(p, params):
    """Face pick by smallest DISTANCE to a face plane along each axis —
    robust for degenerate (zero-extent) boxes, where the reference's
    normalised-coordinate rule divides by a 1e-30 floor and the winning
    axis becomes fp-chaotic (the reference box.pyx tracks the hit slab
    explicitly; this distance rule reproduces that geometric intent from
    the point alone)."""
    lower = params[..., 0:3]
    upper = params[..., 3:6]
    centre = 0.5 * (lower + upper)
    half = 0.5 * (upper - lower)
    dist = jnp.abs(half - jnp.abs(p - centre))
    is_min = dist <= jnp.min(dist, axis=-1, keepdims=True)
    onehot = is_min & (jnp.cumsum(is_min, axis=-1) == 1)
    sign = jnp.where(p - centre >= 0.0, 1.0, -1.0)
    return onehot.astype(p.dtype) * sign


def contains_box(p, params):
    lower = params[..., 0:3]
    upper = params[..., 3:6]
    return jnp.all((p >= lower) & (p <= upper), axis=-1)


# --- cylinder -------------------------------------------------------------------


def candidates_cylinder(o, d, params):
    """Convex solid: interval(infinite tube) intersect slab z in [0, h]."""
    r = params[..., 0]
    h = params[..., 1]
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    roots, valid = solve_quadratic(a, b, c)
    inside_tube = c <= 0.0
    axial = a <= 1e-20
    # tube interval
    tube_lo = jnp.where(axial, jnp.where(inside_tube, -_INF, _INF), roots[..., 0])
    tube_hi = jnp.where(axial, jnp.where(inside_tube, _INF, -_INF), roots[..., 1])
    tube_lo = jnp.where(~axial & ~valid[..., 0], _INF, tube_lo)
    tube_hi = jnp.where(~axial & ~valid[..., 1], -_INF, tube_hi)
    # z-slab interval
    dz = d[..., 2]
    oz = o[..., 2]
    safe_dz = jnp.where(jnp.abs(dz) > 1e-30, dz, 1e-30)
    s0 = (0.0 - oz) / safe_dz
    s1 = (h - oz) / safe_dz
    slab_lo = jnp.minimum(s0, s1)
    slab_hi = jnp.maximum(s0, s1)
    flat = jnp.abs(dz) <= 1e-30
    in_slab = (oz >= 0.0) & (oz <= h)
    slab_lo = jnp.where(flat, jnp.where(in_slab, -_INF, _INF), slab_lo)
    slab_hi = jnp.where(flat, jnp.where(in_slab, _INF, -_INF), slab_hi)
    lo = jnp.maximum(tube_lo, slab_lo)
    hi = jnp.minimum(tube_hi, slab_hi)
    hit = hi >= lo
    return _pack2(lo, hi, hit, hit)


def normal_cylinder(p, params):
    r = params[..., 0]
    h = params[..., 1]
    # distances to the three surfaces, pick the closest
    rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-12)
    d_side = jnp.abs(rad - r)
    d_bot = jnp.abs(p[..., 2])
    d_top = jnp.abs(p[..., 2] - h)
    side_n = jnp.stack(
        [p[..., 0] / rad, p[..., 1] / rad, jnp.zeros_like(rad)], axis=-1
    )
    z = jnp.zeros_like(rad)
    bot_n = jnp.stack([z, z, -jnp.ones_like(rad)], axis=-1)
    top_n = jnp.stack([z, z, jnp.ones_like(rad)], axis=-1)
    n = jnp.where(
        (d_side <= d_bot)[..., None] & (d_side <= d_top)[..., None],
        side_n,
        jnp.where((d_bot <= d_top)[..., None], bot_n, top_n),
    )
    return n


def contains_cylinder(p, params):
    r = params[..., 0]
    h = params[..., 1]
    return (
        (p[..., 0] ** 2 + p[..., 1] ** 2 <= r * r)
        & (p[..., 2] >= 0.0)
        & (p[..., 2] <= h)
    )


# --- cone ---------------------------------------------------------------------


def candidates_cone(o, d, params):
    """Cone: base radius r at z=0, apex at z=h, capped base (cone.pyx:50).

    Surface: x^2 + y^2 = (r (h - z) / h)^2 for z in [0, h].
    Convex solid -> at most two boundary crossings. Collect validated
    quadratic roots (correct nappe) plus the base-cap crossing, then keep
    the (min, max) of the valid set.
    """
    r = params[..., 0]
    h = params[..., 1]
    k = r / h
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    # shift apex to origin pointing down: w = h - z
    wo = h - oz
    wd = -dz
    a = dx * dx + dy * dy - k * k * wd * wd
    b = 2.0 * (ox * dx + oy * dy - k * k * wo * wd)
    c = ox * ox + oy * oy - k * k * wo * wo
    roots, valid = solve_quadratic(a, b, c)
    z0 = oz + roots[..., 0] * dz
    z1 = oz + roots[..., 1] * dz
    v0 = valid[..., 0] & (z0 >= 0.0) & (z0 <= h)
    v1 = valid[..., 1] & (z1 >= 0.0) & (z1 <= h)
    # base cap at z = 0
    safe_dz = jnp.where(jnp.abs(dz) > 1e-30, dz, 1e-30)
    tc = -oz / safe_dz
    px = ox + tc * dx
    py = oy + tc * dy
    vc = (jnp.abs(dz) > 1e-30) & (px * px + py * py <= r * r)
    # gather up to 3 valid crossings; convex -> keep min & max
    t0 = jnp.where(v0, roots[..., 0], _INF)
    t1 = jnp.where(v1, roots[..., 1], _INF)
    t2 = jnp.where(vc, tc, _INF)
    tmin = jnp.minimum(jnp.minimum(t0, t1), t2)
    n0 = jnp.where(v0, roots[..., 0], -_INF)
    n1 = jnp.where(v1, roots[..., 1], -_INF)
    n2 = jnp.where(vc, tc, -_INF)
    tmax = jnp.maximum(jnp.maximum(n0, n1), n2)
    hit = jnp.isfinite(tmin) & (tmax > tmin - 1e-30)
    return _pack2(tmin, tmax, hit, hit & (tmax > tmin))


def normal_cone(p, params):
    r = params[..., 0]
    h = params[..., 1]
    k = r / h
    rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-12)
    # cap if closer to z=0 plane than to the cone surface
    d_cap = jnp.abs(p[..., 2])
    cone_r_at_z = k * (h - p[..., 2])
    d_cone = jnp.abs(rad - cone_r_at_z) / jnp.sqrt(1.0 + k * k)
    # slant normal: (x/rad, y/rad, k) / sqrt(1 + k^2)
    inv = 1.0 / jnp.sqrt(1.0 + k * k)
    side_n = jnp.stack(
        [p[..., 0] / rad * inv, p[..., 1] / rad * inv, k * inv], axis=-1
    )
    z = jnp.zeros_like(rad)
    cap_n = jnp.stack([z, z, -jnp.ones_like(rad)], axis=-1)
    return jnp.where((d_cap <= d_cone)[..., None], cap_n, side_n)


def contains_cone(p, params):
    r = params[..., 0]
    h = params[..., 1]
    k = r / h
    lim = k * (h - p[..., 2])
    return (
        (p[..., 2] >= 0.0)
        & (p[..., 2] <= h)
        & (p[..., 0] ** 2 + p[..., 1] ** 2 <= lim * lim)
    )


# --- parabola -----------------------------------------------------------------


def candidates_parabola(o, d, params):
    """Paraboloid: x^2 + y^2 = (r^2 / h)(h - z), vertex z=h, capped at z=0
    (parabola.pyx:51). Convex solid."""
    r = params[..., 0]
    h = params[..., 1]
    a4 = r * r / h  # "4a" coefficient
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy) + a4 * dz
    c = ox * ox + oy * oy + a4 * (oz - h)
    roots, valid = solve_quadratic(a, b, c)
    z0 = oz + roots[..., 0] * dz
    z1 = oz + roots[..., 1] * dz
    v0 = valid[..., 0] & (z0 >= 0.0) & (z0 <= h)
    v1 = valid[..., 1] & (z1 >= 0.0) & (z1 <= h)
    # axial ray special case: a == 0 -> linear b t + c = 0
    lin = a <= 1e-20
    safe_b = jnp.where(jnp.abs(b) > 1e-30, b, 1e-30)
    tl = -c / safe_b
    zl = oz + tl * dz
    vl = lin & (jnp.abs(b) > 1e-30) & (zl >= 0.0) & (zl <= h)
    v0 = jnp.where(lin, vl, v0)
    t0r = jnp.where(lin, tl, roots[..., 0])
    v1 = jnp.where(lin, False, v1)
    # base cap at z=0
    safe_dz = jnp.where(jnp.abs(dz) > 1e-30, dz, 1e-30)
    tc = -oz / safe_dz
    px = ox + tc * dx
    py = oy + tc * dy
    vc = (jnp.abs(dz) > 1e-30) & (px * px + py * py <= r * r)
    t0 = jnp.where(v0, t0r, _INF)
    t1 = jnp.where(v1, roots[..., 1], _INF)
    t2 = jnp.where(vc, tc, _INF)
    tmin = jnp.minimum(jnp.minimum(t0, t1), t2)
    n0 = jnp.where(v0, t0r, -_INF)
    n1 = jnp.where(v1, roots[..., 1], -_INF)
    n2 = jnp.where(vc, tc, -_INF)
    tmax = jnp.maximum(jnp.maximum(n0, n1), n2)
    hit = jnp.isfinite(tmin)
    return _pack2(tmin, tmax, hit, hit & (tmax > tmin))


def normal_parabola(p, params):
    r = params[..., 0]
    h = params[..., 1]
    a4 = r * r / h
    d_cap = jnp.abs(p[..., 2])
    # gradient of f = x^2 + y^2 + a4 (z - h): (2x, 2y, a4)
    g = jnp.stack(
        [2.0 * p[..., 0], 2.0 * p[..., 1], jnp.broadcast_to(a4, p[..., 0].shape)],
        axis=-1,
    )
    gn = g / jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True) + 1e-12)
    z = jnp.zeros_like(p[..., 0])
    cap_n = jnp.stack([z, z, -jnp.ones_like(z)], axis=-1)
    rad2 = p[..., 0] ** 2 + p[..., 1] ** 2
    surf_dist = jnp.abs(rad2 + a4 * (p[..., 2] - h))
    on_cap = d_cap <= surf_dist * 0.5  # cheap tie-break; exact surfaces dominate
    return jnp.where(on_cap[..., None], cap_n, gn)


def contains_parabola(p, params):
    r = params[..., 0]
    h = params[..., 1]
    a4 = r * r / h
    return (
        (p[..., 2] >= 0.0)
        & (p[..., 0] ** 2 + p[..., 1] ** 2 <= a4 * (h - p[..., 2]))
    )


# --- torus --------------------------------------------------------------------


def torus_root_valid(t, px, py, pz, R, r):
    """Plug-back filter for quartic roots: t is a genuine torus surface
    point iff the implicit residual |(|p_xy| - R)^2 + z^2 - r^2| is small
    RELATIVE to the point's magnitude. The f32 Ferrari+Newton route can
    emit pseudo-roots far from the surface (the quartic coefficients grow
    like |o|^4, so cancellation leaves |poly| ~ eps * |o|^4 ~ 0 at points
    nowhere near the torus); a legitimate polished root's residual is
    ~eps * r * |t| instead."""
    rad2 = px * px + py * py
    rad = jnp.sqrt(rad2 + 1e-12)
    f = (rad - R) * (rad - R) + pz * pz - r * r
    tol = 1e-3 * (R * R + r * r + rad2 + pz * pz)
    return jnp.abs(f) <= tol


def candidates_torus(o, d, params):
    """Torus quartic (torus.pyx:46; solve_quartic per utility.pxd:102).

    The quartic is formed about the ray's point of closest approach to the
    torus centre, not its origin: the coefficients grow like |o|^4, so in
    f32 a distant origin cancels the roots away. Roots are shifted back to
    the caller's ray parameter."""
    R = params[..., 0]
    r = params[..., 1]
    dd = jnp.sum(d * d, axis=-1)
    t_c = -jnp.sum(o * d, axis=-1) / jnp.maximum(dd, 1e-30)
    o = o + t_c[..., None] * d
    od = jnp.sum(o * d, axis=-1)
    oo = jnp.sum(o * o, axis=-1)
    k = oo - r * r - R * R
    a4 = dd * dd
    a3 = 4.0 * dd * od
    a2 = 2.0 * dd * k + 4.0 * od * od + 4.0 * R * R * d[..., 2] ** 2
    a1 = 4.0 * k * od + 8.0 * R * R * o[..., 2] * d[..., 2]
    a0 = k * k - 4.0 * R * R * (r * r - o[..., 2] ** 2)
    roots, valid = solve_quartic(a4, a3, a2, a1, a0, newton_iters=3)
    ts = jnp.where(valid, roots, 0.0)
    px = o[..., 0:1] + ts * d[..., 0:1]
    py = o[..., 1:2] + ts * d[..., 1:2]
    pz = o[..., 2:3] + ts * d[..., 2:3]
    valid = valid & torus_root_valid(ts, px, py, pz, R[..., None],
                                     r[..., None])
    return jnp.where(valid, roots + t_c[..., None], _INF)


def normal_torus(p, params):
    R = params[..., 0]
    rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-12)
    # nearest point on the spine circle
    cx = p[..., 0] / rad * R
    cy = p[..., 1] / rad * R
    n = jnp.stack([p[..., 0] - cx, p[..., 1] - cy, p[..., 2]], axis=-1)
    return n / jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True) + 1e-12)


def contains_torus(p, params):
    R = params[..., 0]
    r = params[..., 1]
    rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + 1e-12)
    return (rad - R) ** 2 + p[..., 2] ** 2 <= r * r


CANDIDATE_FNS = {
    TYPE_SPHERE: candidates_sphere,
    TYPE_BOX: candidates_box,
    TYPE_CYLINDER: candidates_cylinder,
    TYPE_CONE: candidates_cone,
    TYPE_PARABOLA: candidates_parabola,
    TYPE_TORUS: candidates_torus,
}

NORMAL_FNS = {
    TYPE_SPHERE: normal_sphere,
    TYPE_BOX: normal_box,
    TYPE_CYLINDER: normal_cylinder,
    TYPE_CONE: normal_cone,
    TYPE_PARABOLA: normal_parabola,
    TYPE_TORUS: normal_torus,
}

CONTAINS_FNS = {
    TYPE_SPHERE: contains_sphere,
    TYPE_BOX: contains_box,
    TYPE_CYLINDER: contains_cylinder,
    TYPE_CONE: contains_cone,
    TYPE_PARABOLA: contains_parabola,
    TYPE_TORUS: contains_torus,
}
