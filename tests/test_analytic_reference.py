"""intersect_scene on analytic and CSG scenes against a float64 reference.

The scenes are lens stacks, raw CSG solids (union, intersection,
subtraction), every analytic primitive type including the torus, and
mixed scenes of randomly placed primitives. Rays come from
outside the scene, from random points through it, and from points inside
leaves, so the exit crossings (``exiting``) are covered. The reference
(tests/_analytic_reference.py) solves every crossing in closed form in
float64 and resolves CSG booleans by point containment.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _analytic_reference import contains, reference_intersect
from source_tpu.compiler import SpectralConfig, compile_scene
from source_tpu.core.math.transform import rotate_x, rotate_y, translate
from source_tpu.core.math.vector import Point3D
from source_tpu.core.scenegraph.node import World
from source_tpu.optical.material.lambert import Lambert
from source_tpu.primitive import analytic as A
from source_tpu.primitive.csg import Intersect, Subtract, Union
from source_tpu.primitive.lens.spherical import (
    BiConcave, BiConvex, Meniscus, PlanoConcave, PlanoConvex,
)
from source_tpu.primitive.shapes import (
    Box, Cone, Cylinder, Parabola, Sphere, Torus,
)
from source_tpu.tracer.intersect import intersect_scene

# Share of rays whose (hit, entity) may differ from the reference: f32
# against f64 can only disagree on rays that graze an edge or a tangent
# within f32 rounding of it.
MAX_DISAGREE = 0.005


def _compile(w):
    return compile_scene(w, SpectralConfig(400.0, 700.0, 4))


def _mixed(seed, n, torus_and_csg):
    """Random rotated primitives of every quadric type, optionally with a
    torus and a subtraction."""
    w = World()
    rng = np.random.RandomState(seed)
    for i in range(n):
        x, y, z = rng.uniform(-3.0, 3.0, 3)
        t = translate(x, y, z) * rotate_x(float(rng.uniform(0, 90)))
        kind = i % 5
        if kind == 0:
            Sphere(0.4, parent=w, transform=t, material=Lambert())
        elif kind == 1:
            Box(Point3D(-0.3, -0.3, -0.2), Point3D(0.3, 0.3, 0.2),
                parent=w, transform=t, material=Lambert())
        elif kind == 2:
            Cylinder(0.3, 0.6, parent=w, transform=t, material=Lambert())
        elif kind == 3:
            Cone(0.3, 0.6, parent=w, transform=t, material=Lambert())
        else:
            Parabola(0.3, 0.5, parent=w, transform=t, material=Lambert())
    if torus_and_csg:
        Torus(0.5, 0.15, parent=w, transform=translate(0.0, 0.0, 4.0),
              material=Lambert())
        Subtract(Sphere(0.5), Box(Point3D(0, -1, -1), Point3D(1, 1, 1)),
                 parent=w, transform=translate(0.0, 4.0, 0.0),
                 material=Lambert())
    return _compile(w)


def _lens_stack():
    """Lenses of four kinds plus raw CSG solids."""
    w = World()
    rng = np.random.RandomState(0)
    kinds = [BiConvex, BiConcave, PlanoConvex, Meniscus]
    for i in range(8):
        L = kinds[i % 4]
        if L is PlanoConvex:
            p = L(0.1, 0.02, 0.3)
        elif L is Meniscus:
            p = L(0.1, 0.02, 0.25, 0.3)
        else:
            p = L(0.1, 0.02, 0.3, 0.3)
        p.parent = w
        p.transform = (translate((i % 3 - 1) * 0.3, (i // 3 - 1) * 0.3, 0.4 * i)
                       * rotate_x(float(rng.uniform(0, 20))))
        p.material = Lambert()
    Subtract(Sphere(0.5), Box(Point3D(0, -1, -1), Point3D(1, 1, 1)),
             parent=w, transform=translate(0.0, 1.2, 1.0), material=Lambert())
    Union(Sphere(0.3), Cylinder(0.2, 0.6), parent=w,
          transform=translate(-1.2, 0.0, 1.5), material=Lambert())
    Intersect(Sphere(0.4), Sphere(0.4, transform=translate(0.3, 0, 0)),
              parent=w, transform=translate(1.2, 0.0, 2.0), material=Lambert())
    Sphere(0.25, parent=w, transform=translate(0.0, -1.2, 2.5),
           material=Lambert())
    Box(Point3D(-0.2, -0.2, -0.2), Point3D(0.2, 0.2, 0.2), parent=w,
        transform=translate(1.0, 1.0, 3.0), material=Lambert())
    return _compile(w)


def _single(make):
    w = World()
    make(w, translate(0.1, -0.2, 0.3) * rotate_x(25.0) * rotate_y(10.0))
    return _compile(w)


SCENES = {
    "mixed_torus_csg": lambda: _mixed(0, 14, True),
    "mixed_quadrics": lambda: _mixed(3, 12, False),
    "lens_stack": _lens_stack,
    "sphere": lambda: _single(lambda w, t: Sphere(0.7, parent=w, transform=t,
                                                  material=Lambert())),
    "box": lambda: _single(lambda w, t: Box(
        Point3D(-0.5, -0.3, -0.2), Point3D(0.4, 0.6, 0.3), parent=w,
        transform=t, material=Lambert())),
    "cylinder": lambda: _single(lambda w, t: Cylinder(
        0.4, 0.9, parent=w, transform=t, material=Lambert())),
    "cone": lambda: _single(lambda w, t: Cone(
        0.5, 0.8, parent=w, transform=t, material=Lambert())),
    "parabola": lambda: _single(lambda w, t: Parabola(
        0.5, 0.7, parent=w, transform=t, material=Lambert())),
    "torus": lambda: _single(lambda w, t: Torus(
        0.6, 0.2, parent=w, transform=t, material=Lambert())),
    "biconvex": lambda: _single(lambda w, t: BiConvex(
        0.5, 0.12, 0.6, 0.8, parent=w, transform=t, material=Lambert())),
    "biconcave": lambda: _single(lambda w, t: BiConcave(
        0.5, 0.05, 0.6, 0.8, parent=w, transform=t, material=Lambert())),
    "planoconvex": lambda: _single(lambda w, t: PlanoConvex(
        0.5, 0.1, 0.6, parent=w, transform=t, material=Lambert())),
    "planoconcave": lambda: _single(lambda w, t: PlanoConcave(
        0.5, 0.05, 0.6, parent=w, transform=t, material=Lambert())),
    "meniscus": lambda: _single(lambda w, t: Meniscus(
        0.5, 0.06, 0.5, 0.7, parent=w, transform=t, material=Lambert())),
    "csg_union": lambda: _single(lambda w, t: Union(
        Sphere(0.4), Cylinder(0.25, 0.8), parent=w, transform=t,
        material=Lambert())),
    "csg_intersect": lambda: _single(lambda w, t: Intersect(
        Sphere(0.5), Box(Point3D(-0.3, -0.3, -0.6), Point3D(0.3, 0.3, 0.6)),
        parent=w, transform=t, material=Lambert())),
    "csg_subtract": lambda: _single(lambda w, t: Subtract(
        Cylinder(0.5, 0.4), Sphere(0.3, transform=translate(0, 0, 0.4)),
        parent=w, transform=t, material=Lambert())),
}

_CACHE = {}


def scene(name):
    if name not in _CACHE:
        _CACHE[name] = SCENES[name]()
    return _CACHE[name]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _local_box(tid, prm):
    if tid == A.TYPE_SPHERE:
        return -prm[0] * np.ones(3), prm[0] * np.ones(3)
    if tid == A.TYPE_BOX:
        return prm[0:3], prm[3:6]
    if tid == A.TYPE_TORUS:
        e = prm[0] + prm[1]
        return np.array([-e, -e, -prm[1]]), np.array([e, e, prm[1]])
    return np.array([-prm[0], -prm[0], 0.0]), np.array([prm[0], prm[0], prm[1]])


def rays(s, kind, n=1024, seed=5):
    """Ray batches: 'outside' (aimed at leaves from 1 to 4 units away),
    'through' (random origins over the scene's extent, loosely aimed)
    and 'inside' (origins sampled inside leaves)."""
    rng = np.random.RandomState(seed)
    l2w = np.asarray(s.leaf_l2w, np.float64)
    w2l = np.asarray(s.leaf_w2l, np.float64)
    prm = np.asarray(s.leaf_params, np.float64)
    centres = l2w[:, :3, 3]
    lo, hi = centres.min(0) - 1.0, centres.max(0) + 1.0
    if kind == "outside":
        tgt = centres[rng.randint(0, len(centres), n)] + rng.normal(scale=0.1, size=(n, 3))
        o = tgt + _unit(rng.normal(size=(n, 3))) * rng.uniform(1.0, 4.0, (n, 1))
        d = _unit(tgt - o)
    elif kind == "through":
        o = rng.uniform(lo, hi, (n, 3))
        tgt = centres[rng.randint(0, len(centres), n)] + rng.normal(scale=0.3, size=(n, 3))
        d = _unit(tgt - o)
    else:
        ltype = np.zeros(s.n_leaves, int)
        for tid, a, b in s.type_slices:
            ltype[a:b] = tid
        pts = []
        while len(pts) < n:
            g = rng.randint(s.n_leaves)
            blo, bhi = _local_box(ltype[g], prm[g])
            p = rng.uniform(blo, bhi, (64, 3))
            p = p[contains(ltype[g], p, prm[g])]
            pts.extend(p @ l2w[g, :3, :3].T + l2w[g, :3, 3])
        o = np.asarray(pts[:n])
        d = _unit(rng.normal(size=(n, 3)))
    return o.astype(np.float32), d.astype(np.float32)


_intersect = jax.jit(intersect_scene)

CASES = [(name, "outside") for name in SCENES] + [
    (name, kind) for name in ("mixed_torus_csg", "mixed_quadrics", "lens_stack",
                              "sphere", "torus", "meniscus", "csg_subtract")
    for kind in ("through", "inside")]


@pytest.mark.parametrize("name,kind", CASES)
def test_intersect_matches_float64_reference(name, kind):
    s = scene(name)
    o, d = rays(s, kind)
    got = jax.device_get(_intersect(s, jnp.asarray(o), jnp.asarray(d)))
    ref = reference_intersect(s, o, d)
    agree = (got.hit == ref["hit"]) & (~ref["hit"] | (got.entity == ref["entity"]))
    assert agree.mean() >= 1.0 - MAX_DISAGREE, np.flatnonzero(~agree)[:10]
    m = agree & ref["hit"]
    assert m.sum() > 0.1 * len(o)  # the batch genuinely exercises hits
    # f32 hit distances carry a few ulps of the ray's scale, amplified by
    # 1/|cos| of the incidence angle; the torus quartic is solved in f32
    # with Newton polish, so its roots also carry the polynomial's
    # conditioning (~1e3 x f32 epsilon)
    torus = np.isin(ref["leaf"], [g for tid, a, b in s.type_slices
                                  if tid == A.TYPE_TORUS for g in range(a, b)])
    cos = np.abs((ref["normal"] * d).sum(-1))
    scale = np.maximum(1.0, np.maximum(np.abs(ref["t"]), np.abs(o).max(1)))
    tol = np.where(torus, 2e-3, 1e-5 / np.maximum(cos, 0.01)) * scale
    err = np.abs(np.where(m, got.t - ref["t"], 0.0))
    assert (err[m] <= tol[m]).all(), (err[m].max(), np.flatnonzero(m & (err > tol))[:5])
    assert (got.exiting[m] == ref["exiting"][m]).mean() >= 1.0 - MAX_DISAGREE
    if kind == "inside":
        assert ref["exiting"][m].mean() > 0.2  # exit crossings are covered
    cos = (got.normal * ref["normal"]).sum(-1)
    assert (cos[m] > 0.999).mean() >= 1.0 - MAX_DISAGREE, np.sort(cos[m])[:5]


@pytest.mark.parametrize("name", ["mixed_torus_csg", "lens_stack", "cone",
                                  "csg_subtract"])
def test_hit_distance_gradient_matches_finite_differences(name):
    """d(sum of hit t)/d(leaf params) through intersect_scene against
    central differences of the float64 reference."""
    s = scene(name)
    o, d = rays(s, "outside", n=256, seed=9)

    def loss(p):
        rec = intersect_scene(dataclasses.replace(s, leaf_params=p),
                              jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(jnp.where(rec.hit, rec.t, 0.0))

    grad = np.asarray(jax.jit(jax.grad(loss))(s.leaf_params), np.float64)
    base = np.asarray(s.leaf_params, np.float64)
    ref0 = reference_intersect(s, o, d)
    h = 1e-6
    fd = np.zeros_like(base)
    for g in range(base.shape[0]):
        for k in range(base.shape[1]):
            if base[g, k] == 0.0 and not np.any(base[:, k]):
                continue  # unused slot of the parameter block
            up, dn = base.copy(), base.copy()
            up[g, k] += h
            dn[g, k] -= h
            r_up = reference_intersect(s, o, d, leaf_params=up)
            r_dn = reference_intersect(s, o, d, leaf_params=dn)
            # rays whose winner is stable under the perturbation
            keep = (ref0["hit"] & r_up["hit"] & r_dn["hit"]
                    & (r_up["entity"] == ref0["entity"])
                    & (r_dn["entity"] == ref0["entity"])
                    & (r_up["leaf"] == ref0["leaf"])
                    & (r_dn["leaf"] == ref0["leaf"]))
            fd[g, k] = (r_up["t"][keep] - r_dn["t"][keep]).sum() / (2 * h)
    scale = max(np.abs(fd).max(), 1e-6)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad / scale, fd / scale, atol=2e-2)
