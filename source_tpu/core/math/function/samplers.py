"""Function1D sampling utilities.

Counterpart of the reference's function samplers
(raysect/core/math/function/float/function1d/samplers.pyx:41 ``sample1d``,
:81 ``sample1d_points``). The reference loops ``func.evaluate`` per point in
Cython; here Functions are traced array programs, so one vectorised call
evaluates the whole sample grid.
"""

from __future__ import annotations

import numpy as np

from .base import autowrap_function1d

__all__ = ["sample1d", "sample1d_points"]


def sample1d(function, x_min, x_max, x_samples):
    """Sample a Function1D (or python callable) over [x_min, x_max].

    Returns ``(x, f)`` arrays with ``x_samples`` points, endpoints included
    (samplers.pyx:41-77 contract, including its validation errors).
    """
    if x_min > x_max:
        raise ValueError(
            f"x_min ({x_min}) argument cannot be greater than x_max ({x_max})"
        )
    if x_samples < 1:
        raise ValueError("The argument x_samples must be >= 1")
    func = autowrap_function1d(function)
    x = np.linspace(x_min, x_max, x_samples)
    return x, np.asarray(func(x), np.float64)


def sample1d_points(function, x_points):
    """Sample a Function1D at the given points (samplers.pyx:81-110)."""
    x = np.ascontiguousarray(x_points, dtype=np.float64)
    func = autowrap_function1d(function)
    return np.asarray(func(x), np.float64)
