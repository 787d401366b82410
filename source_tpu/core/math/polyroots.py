"""Vectorized polynomial root solvers (quadratic/cubic/quartic).

Vectorised replacement for raysect/core/math/cython/utility.pyx
``solve_quadratic/solve_cubic/solve_quartic`` (utility.pxd:96-109). All
functions are branchless and batched: they return fixed-size root arrays plus
validity masks, so they trace cleanly under ``jit``/``vmap`` and are used by
the analytic primitive hit kernels (sphere/cylinder/cone quadratics, torus
quartic — primitive/torus.pyx:46-90).

Every masked lane is sanitized with the double-where pattern *before* any
sqrt/div/pow so reverse-mode gradients stay finite — the scene geometry is
differentiated through these roots (BASELINE pixel-gradient target).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["solve_quadratic", "solve_cubic", "solve_quartic",
           "solve_quartic_components"]

_INF = jnp.inf


def _safe_sqrt(x, ok=None):
    ok = (x > 0.0) if ok is None else ok
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)


def _safe_div(a, b, eps=1e-30):
    ok = jnp.abs(b) > eps
    return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)


def _cbrt(x, eps=1e-24):
    ax = jnp.abs(x)
    ok = ax > eps
    r = jnp.where(ok, jnp.where(ok, ax, 1.0) ** (1.0 / 3.0), 0.0)
    return jnp.sign(x) * r


def _quad_components(a, b, c, eps=1e-30):
    """solve_quadratic without the stacked [..., 2] axis: returns
    ((lo, v_lo), (hi, v_hi)). ``solve_quadratic`` stacks these same
    values, so the
    streaming and kernel paths share one fp route."""
    d = b * b - 4.0 * a * c
    has_roots = d >= 0.0
    sq = _safe_sqrt(jnp.where(has_roots, d, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sq)
    q = jnp.where(b == 0.0, -0.5 * sq, q)
    lin = jnp.abs(a) < eps
    r0 = jnp.where(lin, _safe_div(-c, b, eps), _safe_div(q, a, eps))
    r1 = _safe_div(c, q, eps)
    v1 = has_roots & ~lin & (jnp.abs(q) >= eps)
    v0 = (lin & (jnp.abs(b) >= eps)) | (~lin & has_roots)
    r1_eff = jnp.where(v1, r1, r0)
    lo = jnp.minimum(r0, r1_eff)
    hi = jnp.maximum(r0, r1_eff)
    return (lo, v0), (hi, v1)


def solve_quadratic(a, b, c, eps=1e-30):
    """Real roots of a x^2 + b x + c = 0.

    Returns (roots[..., 2], valid[..., 2]) with roots sorted ascending where
    valid; invalid lanes hold +inf. Uses the numerically-stable citardauq
    formulation to avoid cancellation.
    """
    (lo, v0), (hi, v1) = _quad_components(a, b, c, eps)
    roots = jnp.stack([jnp.where(v0, lo, _INF), jnp.where(v1, hi, _INF)], axis=-1)
    valid = jnp.stack([v0, v1], axis=-1)
    return roots, valid


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 (a != 0 assumed).

    Returns (roots[..., 3], valid[..., 3]); invalid lanes +inf, roots sorted.
    Trigonometric (Viete) method for the three-real-root case, Cardano for
    the single-root case — both branchless via where-select.
    """
    inv_a = 1.0 / a
    p = b * inv_a
    q = c * inv_a
    r = d * inv_a
    # depressed cubic t^3 + A t + B, x = t - p/3
    A = q - p * p / 3.0
    B = (2.0 * p * p * p - 9.0 * p * q + 27.0 * r) / 27.0
    disc = (B * B) / 4.0 + (A * A * A) / 27.0
    shift = -p / 3.0
    one = disc > 0.0

    # one real root (disc > 0): Cardano
    sq = _safe_sqrt(jnp.where(one, disc, 0.0))
    u = _cbrt(-B / 2.0 + sq)
    v = _cbrt(-B / 2.0 - sq)
    single = u + v + shift

    # three real roots (disc <= 0): trigonometric; requires A < 0
    Am = jnp.minimum(A, -1e-24)
    m = 2.0 * _safe_sqrt(-Am / 3.0)
    denom = Am * m
    arg = jnp.clip(_safe_div(3.0 * B, denom), -0.999999, 0.999999)
    theta = jnp.arccos(arg) / 3.0
    k = jnp.arange(3.0)
    trip = m[..., None] * jnp.cos(theta[..., None] - 2.0 * jnp.pi * k / 3.0) + shift[..., None]

    roots = jnp.where(
        one[..., None],
        jnp.stack(
            [single, jnp.full_like(single, _INF), jnp.full_like(single, _INF)],
            axis=-1,
        ),
        trip,
    )
    valid = jnp.where(
        one[..., None],
        jnp.stack([jnp.ones_like(one), jnp.zeros_like(one), jnp.zeros_like(one)], axis=-1),
        jnp.ones(roots.shape, dtype=bool),
    )
    roots = jnp.where(valid, roots, _INF)
    roots = jnp.sort(roots, axis=-1)
    return roots, jnp.isfinite(roots)


def _acos_poly(x):
    """Polynomial arccos (Abramowitz & Stegun 4.4.45, |err| < 6.7e-5).

    The resolvent-cubic root only needs ~1e-4 accuracy — the quartic's
    Newton polish restores full f32 precision downstream."""
    ax = jnp.abs(x)
    p = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 - 0.0187293 * ax))
    a = _safe_sqrt(1.0 - ax, ok=(1.0 - ax) > 0.0) * p
    return jnp.where(x >= 0.0, a, jnp.float32(3.14159265358979) - a)


def _cubic_largest(b, c, d):
    """Largest real root of the monic cubic x^3 + b x^2 + c x + d (the
    Cardano single root for disc > 0; the k=0 Viete root — the largest of
    the three — otherwise) without the stacked axis. The Viete branch uses
    the polynomial arccos above; callers polish downstream."""
    A = c - b * b / 3.0
    B = (2.0 * b * b * b - 9.0 * b * c + 27.0 * d) / 27.0
    disc = (B * B) / 4.0 + (A * A * A) / 27.0
    shift = -b / 3.0
    one = disc > 0.0
    sq = _safe_sqrt(jnp.where(one, disc, 0.0))
    single = _cbrt(-B / 2.0 + sq) + _cbrt(-B / 2.0 - sq) + shift
    Am = jnp.minimum(A, -1e-24)
    m = 2.0 * _safe_sqrt(-Am / 3.0)
    arg = jnp.clip(_safe_div(3.0 * B, Am * m), -0.999999, 0.999999)
    theta = _acos_poly(arg) / 3.0
    return jnp.where(one, single, m * jnp.cos(theta) + shift)


def solve_quartic_components(a, b, c, d, e, newton_iters=2):
    """``solve_quartic`` without the stacked [..., 4] axis: four
    Newton-polished (root, valid) pairs, unsorted (primitive/torus.pyx
    quartic semantics); ``solve_quartic`` stacks these same values."""
    # degenerate-lane guard: dead/masked rays reach here with a == 0
    # (|d|^4 for the torus quartic); 1/0 = inf would poison reverse-mode
    # through the masked lanes (NaN = 0 * inf), so sanitize a and mark
    # every root invalid instead
    a_ok = jnp.abs(a) > 1e-30
    a = jnp.where(a_ok, a, 1.0)
    inv_a = 1.0 / a
    b_, c_, d_, e_ = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    # depressed quartic y^4 + p y^2 + q y + r, x = y - b/4
    p = c_ - 3.0 * b_ * b_ / 8.0
    q = d_ - b_ * c_ / 2.0 + b_ * b_ * b_ / 8.0
    r = (
        e_
        - b_ * d_ / 4.0
        + b_ * b_ * c_ / 16.0
        - 3.0 * b_ * b_ * b_ * b_ / 256.0
    )
    shift = -b_ / 4.0

    # resolvent cubic: z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0; largest real z
    z = _cubic_largest(-p, -4.0 * r, 4.0 * p * r - q * q)

    # factor into two quadratics y^2 -/+ s y + (z/2 +/- q/(2s)):
    # (y^2 + z/2)^2 - (s y - q/(2s))^2 with s^2 = z - p
    s = _safe_sqrt(z - p)
    deg = s <= 1e-12
    t0 = z / 2.0 + _safe_div(q, 2.0 * s)
    t1 = z / 2.0 - _safe_div(q, 2.0 * s)
    # s == 0 degenerate: y^2 = (-p +/- sqrt(p^2-4r))/2
    dd = _safe_sqrt(p * p - 4.0 * r)
    t0 = jnp.where(deg, (z + dd) / 2.0, t0)
    t1 = jnp.where(deg, (z - dd) / 2.0, t1)

    ones = jnp.ones_like(s)
    (lo0, v00), (hi0, v01) = _quad_components(ones, -s, t0)
    (lo1, v10), (hi1, v11) = _quad_components(ones, s, t1)

    def poly(x):
        return (((a * x + b) * x + c) * x + d) * x + e

    def dpoly(x):
        return ((4.0 * a * x + 3.0 * b) * x + 2.0 * c) * x + d

    def finish(x, v):
        v = v & a_ok
        # sanitize before polishing: masked lanes polish a dummy zero root
        x = jnp.where(v, x + shift, 0.0)
        for _ in range(newton_iters):
            x = jnp.where(v, x - _safe_div(poly(x), dpoly(x)), x)
        return x, v

    return (finish(lo0, v00), finish(hi0, v01),
            finish(lo1, v10), finish(hi1, v11))


def solve_quartic(a, b, c, d, e, newton_iters=2):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 (a != 0 assumed).

    Ferrari resolvent-cubic method, fully batched; optional Newton polishing
    for f32 robustness (the torus intersection is sensitive —
    primitive/torus.pyx quartic path). Returns (roots[..., 4], valid[..., 4])
    sorted ascending with invalid lanes +inf. Thin stacked view of
    ``solve_quartic_components``.
    """
    pairs = solve_quartic_components(a, b, c, d, e, newton_iters)
    roots = jnp.stack([jnp.where(v, x, _INF) for x, v in pairs], axis=-1)
    roots = jnp.sort(roots, axis=-1)
    return roots, jnp.isfinite(roots)
