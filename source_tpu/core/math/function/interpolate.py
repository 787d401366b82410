"""Array interpolators: 1D/2D/3D gridded data -> smooth scalar fields.

Counterparts of the reference's array interpolators
(raysect/core/math/function/float/function1d/interpolate.pyx:45
``Interpolator1DArray``, function2d/interpolate/interpolator2darray.pyx:101,
function3d/interpolate/interpolator3darray.pyx:99): linear or cubic
interpolation with none/nearest/linear/quadratic extrapolation over an
``extrapolation_range``.

Design notes (vs the reference's per-cell polynomial solves):
  * cubic interpolation is local Hermite — knot slopes from second-order
    finite differences (the reference's _ArrayDerivative estimates,
    interpolate.pyx:627) — evaluated separably: every query gathers its
    (4,)^N neighbourhood and reduces one axis at a time, a fixed-size
    fused computation that vmaps and differentiates cleanly;
  * 'none' extrapolation cannot raise inside jit; out-of-range queries
    return NaN (the reference raises ValueError).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import Function1D, Function2D, Function3D

__all__ = ["Interpolator1DArray", "Interpolator2DArray", "Interpolator3DArray"]

_INTERP_TYPES = ("linear", "cubic")
_EXTRAP_TYPES = ("none", "nearest", "linear", "quadratic")


def _check_axis(x, name):
    x = np.asarray(x, np.float64)
    if x.ndim != 1 or x.size < 2:
        raise ValueError(f"{name} must be a 1D array with >= 2 samples.")
    if not np.all(np.diff(x) > 0):
        raise ValueError(f"{name} must be strictly increasing.")
    return x


def _fd_slope(xm, x0, xp, fm, f0, fp):
    """Knot slope at x0 from its neighbours.

    Interior knots: the reference's second-order non-uniform three-point
    formula (interpolate.pyx _ArrayDerivative1D._evaluate_x),
        fx = [fp*dx1^2 - fm*dx0^2 - f0*(dx1^2 - dx0^2)] / (dx0*dx1^2 + dx1*dx0^2)
    with dx0 = xp - x0, dx1 = x0 - xm; reduces to the centred difference on
    even grids. Clamped (duplicated) edge points collapse one of the deltas
    to zero, degrading to the reference's first-order one-sided edge
    estimate (_evaluate_edge_x)."""
    dx0 = xp - x0
    dx1 = x0 - xm
    # clamped windows duplicate coordinates EXACTLY, so compare against zero
    # (a tiny epsilon like 1e-300 underflows to 0 in f32 and never fires)
    lo_edge = dx1 == 0.0
    hi_edge = dx0 == 0.0
    num = fp * dx1 * dx1 - fm * dx0 * dx0 - f0 * (dx1 * dx1 - dx0 * dx0)
    den = dx0 * dx1 * dx1 + dx1 * dx0 * dx0
    interior = jnp.where(den != 0.0, num / jnp.where(den != 0.0, den, 1.0), 0.0)
    one_sided_lo = (fp - f0) / jnp.where(hi_edge, 1.0, dx0)
    one_sided_hi = (f0 - fm) / jnp.where(lo_edge, 1.0, dx1)
    return jnp.where(lo_edge, one_sided_lo, jnp.where(hi_edge, one_sided_hi, interior))


def _hermite_window(x4, f4, q):
    """Cubic Hermite on the middle interval [x4[...,1], x4[...,2]] of a
    4-point window, with FD slopes. q broadcasts against x4[..., 0]."""
    m_a = _fd_slope(x4[..., 0], x4[..., 1], x4[..., 2],
                    f4[..., 0], f4[..., 1], f4[..., 2])
    m_b = _fd_slope(x4[..., 1], x4[..., 2], x4[..., 3],
                    f4[..., 1], f4[..., 2], f4[..., 3])
    h = x4[..., 2] - x4[..., 1]
    hs = jnp.maximum(jnp.abs(h), 1e-30) * jnp.where(h < 0, -1.0, 1.0)
    t = (q - x4[..., 1]) / hs
    f0, f1 = f4[..., 1], f4[..., 2]
    m0, m1 = m_a * hs, m_b * hs
    t2 = t * t
    t3 = t2 * t
    return (
        (2 * t3 - 3 * t2 + 1) * f0
        + (t3 - 2 * t2 + t) * m0
        + (-2 * t3 + 3 * t2) * f1
        + (t3 - t2) * m1
    )


class _GridInterpolator:
    """Shared N-D grid machinery (N = 1, 2, 3)."""

    def __init__(self, axes, f, interpolation_type, extrapolation_type,
                 extrapolation_range, names):
        interpolation_type = interpolation_type.lower()
        extrapolation_type = extrapolation_type.lower()
        if interpolation_type not in _INTERP_TYPES:
            raise ValueError(f"interpolation_type must be one of {_INTERP_TYPES}.")
        if extrapolation_type not in _EXTRAP_TYPES:
            raise ValueError(f"extrapolation_type must be one of {_EXTRAP_TYPES}.")
        if extrapolation_type == "quadratic" and (
            interpolation_type != "cubic" or len(axes) != 1
        ):
            # reference permitted_interpolation_combinations: quadratic
            # extrapolation exists only for the 1D cubic interpolator
            # (interpolate.pyx:745-749; 2D/3D interpolators omit it)
            raise ValueError(
                f"Extrapolation type {extrapolation_type} not compatible with "
                f"interpolation type {interpolation_type}."
            )
        self.interpolation_type = interpolation_type
        self.extrapolation_type = extrapolation_type
        self.extrapolation_range = float(extrapolation_range)

        axes = [_check_axis(a, nm) for a, nm in zip(axes, names)]
        f = np.asarray(f, np.float64)
        if f.shape != tuple(a.size for a in axes):
            raise ValueError("f shape must match the axis lengths.")
        if interpolation_type == "cubic" and any(a.size < 4 for a in axes):
            raise ValueError("cubic interpolation requires >= 4 samples per axis.")
        self._axes = [jnp.asarray(a) for a in axes]
        self._f = jnp.asarray(f)

        if extrapolation_type == "quadratic":
            # data-driven edge curvature matching the reference
            # _Extrapolator1DQuadratic (interpolate.pyx:499-570): a quadratic
            # through the edge knot with the edge first-derivative and the
            # slope CHANGE across the edge cell as curvature
            x0 = axes[0]
            f0 = f
            h_lo = x0[1] - x0[0]
            m0 = (f0[1] - f0[0]) / h_lo
            m1 = self._np_fd_slope(x0[0], x0[1], x0[2], f0[0], f0[1], f0[2])
            self._quad_d2_lo = float((m1 - m0) / h_lo)
            h_hi = x0[-1] - x0[-2]
            m_end = (f0[-1] - f0[-2]) / h_hi
            m_in = self._np_fd_slope(x0[-3], x0[-2], x0[-1], f0[-3], f0[-2], f0[-1])
            self._quad_d2_hi = float((m_end - m_in) / h_hi)

    @staticmethod
    def _np_fd_slope(xm, x0, xp, fm, f0, fp):
        """Host-side interior knot slope (same formula as _fd_slope)."""
        dx0 = xp - x0
        dx1 = x0 - xm
        num = fp * dx1 * dx1 - fm * dx0 * dx0 - f0 * (dx1 * dx1 - dx0 * dx0)
        return num / (dx0 * dx1 * dx1 + dx1 * dx0 * dx0)

    def _eval(self, *qs):
        qs = [jnp.asarray(q, self._f.dtype) for q in qs]
        nd = len(self._axes)
        rng = self.extrapolation_range
        clipped = []
        invalid = None
        for d in range(nd):
            x = self._axes[d]
            q = qs[d]
            if self.extrapolation_type == "none":
                inv = (q < x[0]) | (q > x[-1])
            else:
                inv = (q < x[0] - rng) | (q > x[-1] + rng)
            clipped.append(jnp.clip(q, x[0], x[-1]))
            invalid = inv if invalid is None else (invalid | inv)

        # base value at the clipped (nearest) coordinates
        if self.interpolation_type == "linear":
            val = self._multilinear(clipped)
        else:
            val = self._multicubic(clipped)

        # linear/quadratic extrapolation: multilinear Taylor expansion from
        # the nearest edge point — per-axis first-derivative terms plus the
        # mixed cross terms in corner regions (the reference's
        # _evaluate_edge_xy adds Dx*Dy*d2f/dxdy, interpolator2darray.pyx:837;
        # the 3D extrapolator adds the pairwise and triple products)
        if self.extrapolation_type in ("linear", "quadratic"):
            deltas = [qs[d] - clipped[d] for d in range(nd)]
            # every non-empty axis subset gets its mixed-derivative term
            for mask in range(1, 2 ** nd):
                axes_sel = tuple(d for d in range(nd) if (mask >> d) & 1)
                g = self._edge_derivative(clipped, axes_sel)
                corr = g
                outside = None
                for d in axes_sel:
                    corr = corr * deltas[d]
                    o = deltas[d] != 0.0
                    outside = o if outside is None else (outside & o)
                val = val + jnp.where(outside, corr, 0.0)
            if self.extrapolation_type == "quadratic":
                dq = deltas[0]
                g2 = jnp.where(dq < 0.0, self._quad_d2_lo, self._quad_d2_hi)
                val = val + jnp.where(dq != 0.0, 0.5 * g2 * dq * dq, 0.0)
        return jnp.where(invalid, jnp.nan, val)

    def _edge_derivative(self, clipped, axes_sel):
        """Exact mixed partial derivative of the interpolant (one
        differentiation per axis in ``axes_sel``) at the clipped edge point,
        via autodiff (no FD cancellation in f32)."""
        import jax

        interp = self._multilinear if self.interpolation_type == "linear" else self._multicubic

        def scalar_f(*qs_scalar):
            return interp([q[None] for q in qs_scalar])[0]

        g = scalar_f
        for d in axes_sel:
            g = jax.grad(g, argnums=d)
        shape = jnp.broadcast_shapes(*[jnp.shape(c) for c in clipped])
        flat = [jnp.broadcast_to(c, shape).reshape(-1) for c in clipped]
        out = jax.vmap(g)(*flat)
        return out.reshape(shape)

    def _cell_index(self, d, q):
        x = self._axes[d]
        return jnp.clip(jnp.searchsorted(x, q, side="right") - 1, 0, x.shape[0] - 2)

    def _multilinear(self, qs):
        nd = len(self._axes)
        idx, frac = [], []
        for d in range(nd):
            x = self._axes[d]
            i = self._cell_index(d, qs[d])
            # no clip on t: queries are pre-clipped to the axis range, and
            # clip's tie subgradient (1/2) would corrupt edge derivatives
            t = (qs[d] - x[i]) / jnp.maximum(x[i + 1] - x[i], 1e-30)
            idx.append(i)
            frac.append(t)
        val = 0.0
        for corner in range(2 ** nd):
            w = 1.0
            gather = []
            for d in range(nd):
                bit = (corner >> d) & 1
                w = w * (frac[d] if bit else (1.0 - frac[d]))
                gather.append(idx[d] + bit)
            val = val + w * self._f[tuple(gather)]
        return val

    def _multicubic(self, qs):
        nd = len(self._axes)
        offsets = jnp.arange(-1, 3)
        idx = [self._cell_index(d, qs[d]) for d in range(nd)]
        i4 = [
            jnp.clip(idx[d][..., None] + offsets, 0, self._axes[d].shape[0] - 1)
            for d in range(nd)
        ]
        # gather the (4,)^nd neighbourhood: block [..., 4_0, ..., 4_{nd-1}]
        gather_ix = []
        for d in range(nd):
            shape = i4[d].shape[:-1] + tuple(4 if k == d else 1 for k in range(nd))
            gather_ix.append(i4[d].reshape(shape))
        block = self._f[tuple(gather_ix)]

        # reduce axes from the last to the first with 1D Hermite windows
        for d in reversed(range(nd)):
            x4 = self._axes[d][i4[d]]  # [..., 4]
            # block's last axis is axis d's window; broadcast x4/q across the
            # remaining (earlier) window axes
            extra = block.ndim - 1 - (x4.ndim - 1)
            x4b = x4.reshape(x4.shape[:-1] + (1,) * extra + (4,))
            qb = qs[d].reshape(qs[d].shape + (1,) * extra)
            block = _hermite_window(jnp.broadcast_to(x4b, block.shape), block, qb)
        return block


class Interpolator1DArray(Function1D, _GridInterpolator):
    """1D gridded interpolator (interpolate.pyx:45 API)."""

    def __init__(self, x, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range=float("inf")):
        _GridInterpolator.__init__(self, [x], f, interpolation_type,
                                   extrapolation_type, extrapolation_range, ["x"])

    def __call__(self, x):
        return self._eval(x)


class Interpolator2DArray(Function2D, _GridInterpolator):
    """2D gridded interpolator (interpolator2darray.pyx:101 API)."""

    def __init__(self, x, y, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range_x=float("inf"),
                 extrapolation_range_y=float("inf")):
        _GridInterpolator.__init__(
            self, [x, y], f, interpolation_type, extrapolation_type,
            min(extrapolation_range_x, extrapolation_range_y), ["x", "y"],
        )

    def __call__(self, x, y):
        return self._eval(x, y)


class Interpolator3DArray(Function3D, _GridInterpolator):
    """3D gridded interpolator (interpolator3darray.pyx:99 API)."""

    def __init__(self, x, y, z, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range_x=float("inf"),
                 extrapolation_range_y=float("inf"),
                 extrapolation_range_z=float("inf")):
        _GridInterpolator.__init__(
            self, [x, y, z], f, interpolation_type, extrapolation_type,
            min(extrapolation_range_x, extrapolation_range_y, extrapolation_range_z),
            ["x", "y", "z"],
        )

    def __call__(self, x, y, z):
        return self._eval(x, y, z)
