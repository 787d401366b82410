"""Function framework: composable scalar fields with operator algebra.

Counterpart of the reference's Function1D/2D/3D class forest
(raysect/core/math/function/float/function{1,2,3}d/base.pyx:39-855 — Add/
Sub/Mul/Div/Modulo/Pow/Abs/comparison nodes, function⊗function and
function⊗scalar variants; autowrap.pyx:38-90 coercion; Arg/Constant and the
cmath wrappers; Blend1D/2D/3D mask interpolation). Instead of one Cython
class per (operator × arity × operand kind), a Function here is a thin
Python node whose ``__call__`` evaluates batched jnp arrays, so an entire
expression tree traces into a single fused XLA computation and is
differentiable end to end.

The three arities share one implementation: ``_make_function_classes(n)``
stamps out Function1D/2D/3D (and their Arg/Constant/Blend/math-wrapper
companions) with the right argument count.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "Function1D", "Function2D", "Function3D",
    "Arg1D", "Arg2D", "Arg3D",
    "Constant1D", "Constant2D", "Constant3D",
    "Blend1D", "Blend2D", "Blend3D",
    "PythonFunction1D", "PythonFunction2D", "PythonFunction3D",
    "autowrap_function1d", "autowrap_function2d", "autowrap_function3d",
    "Exp1D", "Exp2D", "Exp3D", "Sin1D", "Sin2D", "Sin3D",
    "Cos1D", "Cos2D", "Cos3D", "Tan1D", "Tan2D", "Tan3D",
    "Asin1D", "Asin2D", "Asin3D", "Acos1D", "Acos2D", "Acos3D",
    "Atan1D", "Atan2D", "Atan3D", "Atan4Q1D", "Atan4Q2D", "Atan4Q3D",
    "Erf1D", "Erf2D", "Erf3D", "Sqrt1D", "Sqrt2D", "Sqrt3D",
]


def _make_function_classes(n):
    """Create the Function/Arg/Constant/Blend/autowrap family of arity n."""

    class Function:
        """Scalar field of arity %d with full operator algebra.""" % n

        _arity = n

        def __call__(self, *args):
            raise NotImplementedError

        # --- algebra (base.pyx operator nodes) --------------------------------
        def __add__(self, other):
            return _binary(self, other, jnp.add)

        def __radd__(self, other):
            return _binary(other, self, jnp.add)

        def __sub__(self, other):
            return _binary(self, other, jnp.subtract)

        def __rsub__(self, other):
            return _binary(other, self, jnp.subtract)

        def __mul__(self, other):
            return _binary(self, other, jnp.multiply)

        def __rmul__(self, other):
            return _binary(other, self, jnp.multiply)

        def __truediv__(self, other):
            return _binary(self, other, jnp.divide)

        def __rtruediv__(self, other):
            return _binary(other, self, jnp.divide)

        def __mod__(self, other):
            return _binary(self, other, jnp.mod)

        def __rmod__(self, other):
            return _binary(other, self, jnp.mod)

        def __pow__(self, other):
            return _binary(self, other, jnp.power)

        def __rpow__(self, other):
            return _binary(other, self, jnp.power)

        def __neg__(self):
            return _unary(self, jnp.negative)

        def __pos__(self):
            return self

        def __abs__(self):
            return _unary(self, jnp.abs)

        # comparisons return 0/1-valued functions (base.pyx richcmp nodes)
        def __eq__(self, other):
            return _binary(self, other, lambda a, b: (a == b).astype(jnp.float32))

        def __ne__(self, other):
            return _binary(self, other, lambda a, b: (a != b).astype(jnp.float32))

        def __lt__(self, other):
            return _binary(self, other, lambda a, b: (a < b).astype(jnp.float32))

        def __le__(self, other):
            return _binary(self, other, lambda a, b: (a <= b).astype(jnp.float32))

        def __gt__(self, other):
            return _binary(self, other, lambda a, b: (a > b).astype(jnp.float32))

        def __ge__(self, other):
            return _binary(self, other, lambda a, b: (a >= b).astype(jnp.float32))

        __hash__ = object.__hash__

    class _Lambda(Function):
        """Internal node evaluating a jnp closure."""

        def __init__(self, fn, repr_name="lambda"):
            self._fn = fn
            self._repr = repr_name

        def __call__(self, *args):
            return self._fn(*args)

        def __repr__(self):
            return f"<{Function.__name__}:{self._repr}>"

    class Constant(Function):
        """Constant field (Constant1D/2D/3D)."""

        def __init__(self, value):
            self.value = float(value)

        def __call__(self, *args):
            if args:
                return jnp.broadcast_to(
                    jnp.asarray(self.value), jnp.shape(jnp.asarray(args[0]))
                )
            return jnp.asarray(self.value)

    class PythonFunction(Function):
        """Wrap an arbitrary callable (autowrap.pyx PythonFunctionXD)."""

        def __init__(self, function):
            self.function = function

        def __call__(self, *args):
            return self.function(*args)

    def autowrap(obj):
        """Coerce Function | callable | number to a Function
        (autowrap.pyx:38-90)."""
        if isinstance(obj, Function):
            return obj
        if callable(obj):
            return PythonFunction(obj)
        return Constant(obj)

    def _unary(f, op):
        f = autowrap(f)
        return _Lambda(lambda *a: op(f(*a)), op.__name__ if hasattr(op, "__name__") else "op")

    def _binary(f, g, op):
        f = autowrap(f)
        g = autowrap(g)
        return _Lambda(lambda *a: op(f(*a), g(*a)), getattr(op, "__name__", "op"))

    class Blend(Function):
        """f1 + (f2 - f1) * clamp(mask, 0, 1) (BlendXD semantics)."""

        def __init__(self, f1, f2, mask):
            self._f1 = autowrap(f1)
            self._f2 = autowrap(f2)
            self._mask = autowrap(mask)

        def __call__(self, *args):
            a = self._f1(*args)
            b = self._f2(*args)
            m = jnp.clip(self._mask(*args), 0.0, 1.0)
            return a + (b - a) * m

    # Arg functions: ArgXD('x'|'y'|'z') selects one coordinate
    _AXES = "xyz"[:n]

    class Arg(Function):
        """Coordinate selector (Arg1D/2D/3D)."""

        def __init__(self, axis="x"):
            if axis not in _AXES:
                raise ValueError(f"axis must be one of {_AXES!r}")
            self.axis = axis
            self._idx = _AXES.index(axis)

        def __call__(self, *args):
            return jnp.asarray(args[self._idx])

    return Function, _Lambda, Constant, PythonFunction, autowrap, Blend, Arg


(Function1D, _Lambda1D, Constant1D, PythonFunction1D, autowrap_function1d,
 Blend1D, Arg1D) = _make_function_classes(1)
(Function2D, _Lambda2D, Constant2D, PythonFunction2D, autowrap_function2d,
 Blend2D, Arg2D) = _make_function_classes(2)
(Function3D, _Lambda3D, Constant3D, PythonFunction3D, autowrap_function3d,
 Blend3D, Arg3D) = _make_function_classes(3)

Function1D.__name__ = "Function1D"
Function2D.__name__ = "Function2D"
Function3D.__name__ = "Function3D"


def _math_wrapper(op, lam_cls, autowrap):
    class _Wrapper(lam_cls.__mro__[1]):  # subclass of the Function base
        def __init__(self, f):
            self._f = autowrap(f)

        def __call__(self, *args):
            return op(self._f(*args))

    return _Wrapper


def _atan2_wrapper(lam_cls, autowrap):
    class _Atan4Q(lam_cls.__mro__[1]):
        """Four-quadrant arctangent of two functions (Atan4QXD)."""

        def __init__(self, f_num, f_den):
            self._fn = autowrap(f_num)
            self._fd = autowrap(f_den)

        def __call__(self, *args):
            return jnp.arctan2(self._fn(*args), self._fd(*args))

    return _Atan4Q


def _erf(x):
    try:
        from jax.scipy.special import erf as _e

        return _e(x)
    except Exception:  # pragma: no cover
        return jnp.tanh(1.202 * x)  # cheap fallback


_MATH_OPS = {
    "Exp": jnp.exp, "Sin": jnp.sin, "Cos": jnp.cos, "Tan": jnp.tan,
    "Asin": jnp.arcsin, "Acos": jnp.arccos, "Atan": jnp.arctan,
    "Erf": _erf, "Sqrt": jnp.sqrt,
}

for _name, _op in _MATH_OPS.items():
    for _dim, (_lam, _aw) in {
        "1D": (_Lambda1D, autowrap_function1d),
        "2D": (_Lambda2D, autowrap_function2d),
        "3D": (_Lambda3D, autowrap_function3d),
    }.items():
        _cls = _math_wrapper(_op, _lam, _aw)
        _cls.__name__ = f"{_name}{_dim}"
        globals()[f"{_name}{_dim}"] = _cls

Atan4Q1D = _atan2_wrapper(_Lambda1D, autowrap_function1d)
Atan4Q2D = _atan2_wrapper(_Lambda2D, autowrap_function2d)
Atan4Q3D = _atan2_wrapper(_Lambda3D, autowrap_function3d)
Atan4Q1D.__name__ = "Atan4Q1D"
Atan4Q2D.__name__ = "Atan4Q2D"
Atan4Q3D.__name__ = "Atan4Q3D"
