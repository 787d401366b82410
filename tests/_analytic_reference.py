"""Float64 numpy reference for ``intersect_scene`` on analytic scenes.

Independent of the tracer's algorithm: every leaf's boundary crossings
come from closed forms in float64 (quadratics; the torus quartic through
companion-matrix eigenvalues polished by Newton steps), and an entity's
hit is the first crossing where its containment — evaluated by point tests
just before and just after the crossing — changes. The tracer instead
streams f32 candidate kernels and resolves CSG by crossing parity.

The reference reads the scene's own tables (``leaf_w2l``, ``leaf_params``,
type slices, CSG programs) cast to float64, so both sides intersect the same
geometry and tolerances only have to cover arithmetic.
"""

import numpy as np

from source_tpu.primitive import analytic as A
from source_tpu.primitive.shapes import OP_INTERSECT, OP_LEAF, OP_SUBTRACT, OP_UNION

INF = np.inf


def _quadratic(a, b, c):
    """Both real roots of a t^2 + b t + c (linear when a == 0); NaN when
    absent. Returns [N, 2]."""
    a, b, c = np.broadcast_arrays(a, b, c)
    out = np.full(a.shape + (2,), np.nan)
    lin = np.abs(a) < 1e-300
    with np.errstate(divide="ignore", invalid="ignore"):
        disc = b * b - 4 * a * c
        sq = np.sqrt(np.where(disc >= 0, disc, np.nan))
        q = -0.5 * (b + np.copysign(sq, b))
        r0, r1 = q / a, c / q
        out[..., 0] = np.where(lin, -c / b, np.minimum(r0, r1))
        out[..., 1] = np.where(lin, np.nan, np.maximum(r0, r1))
    return out


def _cap(o, d, z, r2):
    """Crossing of the plane z = const inside radius^2 r2: [N]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (z - o[:, 2]) / d[:, 2]
    p = o + t[:, None] * d
    return np.where(p[:, 0] ** 2 + p[:, 1] ** 2 <= r2, t, np.nan)


def _in_z(o, d, t, h):
    z = o[:, None, 2] + t * d[:, None, 2]
    return np.where((z >= 0) & (z <= h), t, np.nan)


def crossings(tid, o, d, prm):
    """All boundary crossings of one leaf in its local frame: t [N, K] (NaN
    where absent) and the outward local normal there [N, K, 3]."""
    if tid == A.TYPE_SPHERE:
        r = prm[0]
        t = _quadratic((d * d).sum(1), 2 * (o * d).sum(1), (o * o).sum(1) - r * r)
    elif tid == A.TYPE_BOX:
        lo, hi = prm[0:3], prm[3:6]
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (lo - o) / d, (hi - o) / d
        flat = d == 0
        inside = (o >= lo) & (o <= hi)
        t0 = np.where(flat, np.where(inside, -INF, INF), t0)
        t1 = np.where(flat, np.where(inside, INF, -INF), t1)
        tn = np.minimum(t0, t1).max(1)
        tf = np.maximum(t0, t1).min(1)
        ok = tf >= tn
        t = np.stack([np.where(ok, tn, np.nan), np.where(ok, tf, np.nan)], 1)
    elif tid == A.TYPE_CYLINDER:
        r, h = prm[0], prm[1]
        side = _quadratic(d[:, 0] ** 2 + d[:, 1] ** 2,
                          2 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]),
                          o[:, 0] ** 2 + o[:, 1] ** 2 - r * r)
        t = np.concatenate([_in_z(o, d, side, h), _cap(o, d, 0.0, r * r)[:, None],
                            _cap(o, d, h, r * r)[:, None]], 1)
    elif tid == A.TYPE_CONE:
        r, h = prm[0], prm[1]
        k2 = (r / h) ** 2
        wo, wd = h - o[:, 2], -d[:, 2]
        side = _quadratic(d[:, 0] ** 2 + d[:, 1] ** 2 - k2 * wd * wd,
                          2 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1] - k2 * wo * wd),
                          o[:, 0] ** 2 + o[:, 1] ** 2 - k2 * wo * wo)
        t = np.concatenate([_in_z(o, d, side, h), _cap(o, d, 0.0, r * r)[:, None]], 1)
    elif tid == A.TYPE_PARABOLA:
        r, h = prm[0], prm[1]
        a4 = r * r / h
        side = _quadratic(d[:, 0] ** 2 + d[:, 1] ** 2,
                          2 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]) + a4 * d[:, 2],
                          o[:, 0] ** 2 + o[:, 1] ** 2 + a4 * (o[:, 2] - h))
        t = np.concatenate([_in_z(o, d, side, h), _cap(o, d, 0.0, r * r)[:, None]], 1)
    elif tid == A.TYPE_TORUS:
        t = _torus_roots(o, d, prm[0], prm[1])
    else:
        raise ValueError(tid)
    p = o[:, None, :] + np.nan_to_num(t)[..., None] * d[:, None, :]
    return t, normal(tid, p, prm)


def _torus_roots(o, d, R, r):
    dd, od, oo = (d * d).sum(1), (o * d).sum(1), (o * o).sum(1)
    k = oo - r * r - R * R
    c = np.stack([dd * dd, 4 * dd * od,
                  2 * dd * k + 4 * od * od + 4 * R * R * d[:, 2] ** 2,
                  4 * k * od + 8 * R * R * o[:, 2] * d[:, 2],
                  k * k - 4 * R * R * (r * r - o[:, 2] ** 2)], 1)
    c = c / c[:, :1]
    comp = np.zeros((len(o), 4, 4))
    comp[:, 0, :] = -c[:, 1:]
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    z = np.linalg.eigvals(comp)
    t = np.where(np.abs(z.imag) <= 1e-6 * (1 + np.abs(z.real)), z.real, np.nan)
    for _ in range(4):  # Newton polish on the monic quartic
        f = (((t + c[:, 1:2]) * t + c[:, 2:3]) * t + c[:, 3:4]) * t + c[:, 4:5]
        g = ((4 * t + 3 * c[:, 1:2]) * t + 2 * c[:, 2:3]) * t + c[:, 3:4]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(g) > 0, t - f / g, t)
    return t


def normal(tid, p, prm):
    """Outward local normal (unnormalised gradient) at surface points p."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if tid == A.TYPE_SPHERE:
        return p
    if tid == A.TYPE_BOX:
        lo, hi = prm[0:3], prm[3:6]
        dist = np.stack([np.abs(p - lo), np.abs(p - hi)], -1)  # [..., 3, 2]
        flat = dist.reshape(p.shape[:-1] + (6,)).argmin(-1)
        axis, side = flat // 2, flat % 2
        n = np.zeros_like(p)
        np.put_along_axis(n, axis[..., None], np.where(side, 1.0, -1.0)[..., None], -1)
        return n
    if tid in (A.TYPE_CYLINDER, A.TYPE_CONE, A.TYPE_PARABOLA):
        r, h = prm[0], prm[1]
        if tid == A.TYPE_CYLINDER:
            side = np.stack([x, y, 0 * z], -1)
            d_side = np.abs(np.hypot(x, y) - r)
        elif tid == A.TYPE_CONE:
            k2 = (r / h) ** 2
            side = np.stack([x, y, k2 * (h - z)], -1)
            d_side = np.abs(x * x + y * y - k2 * (h - z) ** 2)
        else:
            a4 = r * r / h
            side = np.stack([x, y, 0.5 * a4 + 0 * z], -1)
            d_side = np.abs(x * x + y * y + a4 * (z - h))
        down = np.broadcast_to([0.0, 0.0, -1.0], p.shape)
        up = np.broadcast_to([0.0, 0.0, 1.0], p.shape)
        cap = np.where((np.abs(z) <= np.abs(z - h))[..., None], down, up)
        d_cap = np.minimum(np.abs(z), np.abs(z - h) if tid == A.TYPE_CYLINDER else INF)
        return np.where((d_cap < d_side)[..., None], cap, side)
    if tid == A.TYPE_TORUS:
        R = prm[0]
        s = (p * p).sum(-1) + R * R - prm[1] ** 2
        return np.stack([4 * x * s - 8 * R * R * x, 4 * y * s - 8 * R * R * y,
                         4 * z * s], -1)
    raise ValueError(tid)


def contains(tid, p, prm):
    """Point-in-solid test in the leaf's local frame."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if tid == A.TYPE_SPHERE:
        return (p * p).sum(-1) <= prm[0] ** 2
    if tid == A.TYPE_BOX:
        return ((p >= prm[0:3]) & (p <= prm[3:6])).all(-1)
    r, h = prm[0], prm[1]
    if tid == A.TYPE_CYLINDER:
        return (x * x + y * y <= r * r) & (z >= 0) & (z <= h)
    if tid == A.TYPE_CONE:
        return (z >= 0) & (z <= h) & (x * x + y * y <= (r / h * (h - z)) ** 2)
    if tid == A.TYPE_PARABOLA:
        return (z >= 0) & (x * x + y * y <= r * r / h * (h - z))
    if tid == A.TYPE_TORUS:
        return (np.hypot(x, y) - r) ** 2 + z * z <= prm[1] ** 2
    raise ValueError(tid)


def _eval_program(program, leaf_inside):
    stack = []
    for op, arg in program:
        if op == OP_LEAF:
            stack.append(leaf_inside[arg])
        else:
            b, a = stack.pop(), stack.pop()
            stack.append({OP_UNION: a | b, OP_INTERSECT: a & b,
                          OP_SUBTRACT: a & ~b}[op])
    return stack[0]


def reference_intersect(scene, origin, direction, leaf_params=None):
    """Nearest hit per ray: dict of hit, t, entity, leaf, exiting and unit
    world normal (oriented as intersect_scene orients it). ``leaf_params``
    overrides the scene's table (for finite differences)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    n = len(o)
    w2l = np.asarray(scene.leaf_w2l, np.float64)
    prm = np.asarray(scene.leaf_params if leaf_params is None else leaf_params,
                     np.float64)
    ltype = np.zeros(scene.n_leaves, int)
    for tid, a, b in scene.type_slices:
        ltype[a:b] = tid
    # the tracer ignores crossings closer than its relative minimum advance
    eps = 1e-4 * np.maximum(1.0, np.abs(o).max(1))

    def local(g, pts):
        with np.errstate(invalid="ignore"):  # rays past their last root
            return pts @ w2l[g, :3, :3].T + w2l[g, :3, 3]

    entities = []  # (entity, leaf ids, program over local leaf positions)
    csg = {e: (ids, prog) for e, ids, prog in scene.csg_entities}
    for e in range(scene.n_entities):
        if e in csg:
            entities.append((e,) + csg[e])
        elif scene.simple_leaf_of_entity[e] >= 0:
            entities.append((e, (scene.simple_leaf_of_entity[e],), ((OP_LEAF, 0),)))

    best = dict(t=np.full(n, INF), entity=np.full(n, -1), leaf=np.zeros(n, int),
                exiting=np.zeros(n, bool), normal=np.zeros((n, 3)))
    for e, ids, program in entities:
        ts, ns, src = [], [], []
        for g in ids:
            t, nl = crossings(ltype[g], local(g, o), d @ w2l[g, :3, :3].T, prm[g])
            ts.append(t)
            # local normal -> world with the inverse transpose of l2w = w2l^T
            ns.append(nl @ w2l[g, :3, :3])
            src.append(np.full(t.shape, g))
        t = np.concatenate(ts, 1)
        nw = np.concatenate(ns, 1)
        src = np.concatenate(src, 1)
        t = np.where(np.isfinite(t) & (t > eps[:, None]), t, INF)
        order = np.argsort(t, 1)
        t = np.take_along_axis(t, order, 1)
        nw = np.take_along_axis(nw, order[..., None], 1)
        src = np.take_along_axis(src, order, 1)
        delta = 1e-7 * np.maximum(1.0, np.abs(t))
        t_fin = np.where(np.isfinite(t), t, 0.0)

        def inside(tt):
            p = o[:, None, :] + tt[..., None] * d[:, None, :]
            return _eval_program(program, [
                contains(ltype[g], local(g, p), prm[g]) for g in ids])

        before, after = inside(t_fin - delta), inside(t_fin + delta)
        boundary = np.isfinite(t) & (before != after)
        first = np.where(boundary.any(1), boundary.argmax(1), -1)
        rows = np.arange(n)
        te = np.where(first >= 0, t[rows, first], INF)
        better = te < best["t"]
        best["t"] = np.where(better, te, best["t"])
        best["entity"] = np.where(better, e, best["entity"])
        best["leaf"] = np.where(better, src[rows, first], best["leaf"])
        best["exiting"] = np.where(better, before[rows, first], best["exiting"])
        best["normal"] = np.where(better[:, None], nw[rows, first], best["normal"])
    hit = np.isfinite(best["t"])
    nrm = best["normal"] / np.maximum(np.linalg.norm(best["normal"], axis=1,
                                                     keepdims=True), 1e-300)
    # orient like the tracer: along the ray when exiting, against it entering
    flip = np.where(best["exiting"], (nrm * d).sum(1) < 0, (nrm * d).sum(1) > 0)
    best["normal"] = np.where(flip[:, None], -nrm, nrm)
    best["hit"] = hit
    return best
