"""Batched scene intersection for the wavefront tracer.

Vectorised replacement for the reference's World.hit -> kd-tree -> per-object
Primitive.hit chain (SURVEY.md §3.3). For every ray in a batch it computes
ALL leaf boundary crossings with the grouped-by-type analytic kernels, then
resolves entities:

  * simple entities: nearest positive crossing of their single leaf
    (scatter-min over the leaf->entity map);
  * CSG entities: the bounded all-hits formulation of csg.pyx:132-241 — sort
    the union of the children's crossings and pick the first t where the
    compiled boolean inside-state flips across the crossing.

Returns a HitRecord SoA. Everything is fixed-shape, branchless and
differentiable w.r.t. scene geometry (transforms + param blocks).

Float32 epsilon strategy: the reference uses 1e-9 absolute offsets in f64
(sphere.pyx:42); in f32 we use scale-relative offsets
``eps * max(1, |t|, |p|)`` (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import batch as vmath
from ..primitive import analytic as _a
from ..compiler.scene import CompiledScene, _program_to_closure
from . import meshtrace
from .meshtrace import mesh_forest_intersect, mesh_intersect

__all__ = ["HitRecord", "intersect_scene", "leaf_candidates", "leaf_contains", "entity_contains", "T_EPS"]

_INF = jnp.inf
T_EPS = 1e-4  # minimum ray-parameter advance (relative-scaled below)

# benign parameter block used on masked-out lanes of the normal dispatch:
# unit box [0,1]^3 doubles as unit radius/height for the quadric types
# numpy (not jnp): module-level device constants would initialise the XLA
# backend at import time, which breaks jax.distributed.initialize() in
# multi-process runs (it must run before any backend touch)
_SAFE_PARAMS = np.asarray([1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 1.0, 1.0], np.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HitRecord:
    """Per-ray intersection result (reference Intersection,
    core/intersection.pyx:35, flattened to SoA)."""

    hit: Any  # bool[N]
    t: Any  # f32[N]
    entity: Any  # i32[N] (-1 on miss)
    leaf: Any  # i32[N]
    point: Any  # f32[N,3] world hit point
    normal: Any  # f32[N,3] outward solid normal, world space, unit
    exiting: Any  # bool[N] ray was inside the solid (reference 'exiting')
    inside_point: Any  # f32[N,3] epsilon-displaced relaunch point inside
    outside_point: Any  # f32[N,3] epsilon-displaced relaunch point outside
    tri: Any = None  # i32[N] winning triangle for mesh entities (-1 otherwise)
    bary_u: Any = None  # f32[N] barycentric u of the mesh hit
    bary_v: Any = None  # f32[N] barycentric v of the mesh hit


# below this slice width the per-leaf elementwise mat-vecs are used; wider
# slices fold into one matrix product per quantity (crossover not measured
# on the H100 yet)
_MATMUL_TRANSFORM_MIN_LEAVES = 16


def _rays_to_local(w2l, origin, direction):
    """Transform a ray batch into EVERY leaf frame of a slice with one
    contraction per quantity instead of N*l elementwise mat-vecs: the
    per-leaf affine rows fold into a [4, 3l] table and ``[N,4] @ [4,3l]``
    yields all local origins at once (same trick as the dense mesh forest,
    meshtrace.py). f32 precision is forced — geometry must not drop to
    TF32. Returns (o_loc, d_loc) as [N, l, 3]."""
    l = w2l.shape[0]
    if l < _MATMUL_TRANSFORM_MIN_LEAVES:
        o_loc = vmath.transform_point(w2l[None, :], origin[:, None, :])
        d_loc = vmath.transform_vector(w2l[None, :], direction[:, None, :])
        return o_loc, d_loc
    M = w2l[:, :3, :].transpose(2, 0, 1).reshape(4, l * 3)  # [j, (l,i)]
    o_h = jnp.concatenate(
        [origin, jnp.ones((origin.shape[0], 1), origin.dtype)], axis=-1
    )
    o_loc = jax.lax.dot_general(
        o_h, M, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, l, 3)
    d_loc = jax.lax.dot_general(
        direction, M[:3], (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, l, 3)
    return o_loc, d_loc


def _points_to_local(w2l, point):
    """Points [..., 3] into every leaf frame of a slice: [..., l, 3]."""
    l = w2l.shape[0]
    if l < _MATMUL_TRANSFORM_MIN_LEAVES:
        return vmath.transform_point(w2l, point[..., None, :])
    lead = point.shape[:-1]
    M = w2l[:, :3, :].transpose(2, 0, 1).reshape(4, l * 3)
    p = point.reshape(-1, 3)
    p_h = jnp.concatenate([p, jnp.ones((p.shape[0], 1), p.dtype)], axis=-1)
    p_loc = jax.lax.dot_general(
        p_h, M, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(lead + (l, 3))
    return p_loc


def leaf_candidates(scene: CompiledScene, origin, direction):
    """All boundary crossings per (ray, leaf): t[N, L, K] sorted, +inf pad.

    Rays are transformed into each leaf's local frame; each primitive type's
    kernel runs on its static leaf slice (no lax.switch, zero masking waste).
    """
    parts = []
    for type_id, start, stop in scene.type_slices:
        w2l = scene.leaf_w2l[start:stop]  # [l,4,4]
        params = scene.leaf_params[start:stop]  # [l,PB]
        # local rays: [N, l, 3]
        o_loc, d_loc = _rays_to_local(w2l, origin, direction)
        t = _a.CANDIDATE_FNS[type_id](o_loc, d_loc, params[None, :, :])
        parts.append(t)
    return jnp.concatenate(parts, axis=1)  # [N, L, K]


def leaf_contains(scene: CompiledScene, point):
    """Point-in-leaf tests: bool[..., L] for points [..., 3]."""
    parts = []
    for type_id, start, stop in scene.type_slices:
        w2l = scene.leaf_w2l[start:stop]
        params = scene.leaf_params[start:stop]
        p_loc = _points_to_local(w2l, point)
        parts.append(_a.CONTAINS_FNS[type_id](p_loc, params))
    return jnp.concatenate(parts, axis=-1)


def entity_contains(scene: CompiledScene, point):
    """Point-in-entity tests: bool[..., E] (reference World.contains,
    core/scenegraph/world.pyx:149, used for volume integration)."""
    E = scene.n_entities
    out = jnp.zeros(point.shape[:-1] + (E,), dtype=bool)
    if scene.n_leaves:
        lc = leaf_contains(scene, point)  # [..., L]
        # simple entities: containment == their leaf's containment
        for e, leaf_idx in enumerate(scene.simple_leaf_of_entity):
            if leaf_idx >= 0:
                out = out.at[..., e].set(lc[..., leaf_idx])
        for e, leaf_ids, program in scene.csg_entities:
            gathered = lc[..., jnp.asarray(leaf_ids)]
            out = out.at[..., e].set(_program_to_closure(program)(gathered))
    # closed meshes: +z probe ray, nearest-hit face orientation
    # (mesh.pyx:805-831: inside iff the nearest surface seen is a backface)
    for e, slot in scene.mesh_entities:
        mesh = scene.meshes[slot]
        if not mesh.closed:
            continue
        flat = point.reshape(-1, 3)
        o_loc = vmath.transform_point(mesh.w2l[None], flat)
        d_loc = vmath.transform_vector(
            mesh.w2l[None], jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], flat.dtype), flat.shape)
        )
        res = mesh_intersect(mesh, o_loc, d_loc, jnp.zeros(flat.shape[0], flat.dtype))
        inside = (res["tri"] >= 0) & ~res["front"]
        out = out.at[..., e].set(inside.reshape(point.shape[:-1]))
    return out


def _leaf_type_of(scene: CompiledScene, leaf_idx):
    """Per-ray analytic type of a (gathered) leaf index, from the static
    type slices."""
    leaf_type = jnp.zeros_like(leaf_idx)
    for type_id, start, stop in scene.type_slices:
        leaf_type = jnp.where(
            (leaf_idx >= start) & (leaf_idx < stop), type_id, leaf_type
        )
    return leaf_type


def _leaf_rows(scene: CompiledScene, leaf_idx):
    """Fused per-ray [w2l | params] row select — ONE one-hot contraction
    serves both tables (halves the dominant [N, L] one-hot traffic on
    large scenes). Returns (w2l[N,4,4], params[N,PB]), differentiable."""
    L = scene.n_leaves
    fused = jnp.concatenate(
        [scene.leaf_w2l.reshape(L, 16), scene.leaf_params,
         scene.leaf_entity.astype(scene.leaf_w2l.dtype)[:, None]], axis=1
    )
    rows = vmath.select_rows(fused, leaf_idx)
    return (rows[..., :16].reshape(leaf_idx.shape + (4, 4)),
            rows[..., 16:-1],
            jnp.round(rows[..., -1]).astype(jnp.int32))


def _leaf_contains_single(scene: CompiledScene, leaf_idx, point, rows=None):
    """Point-in-leaf for ONE (gathered) leaf per ray: bool[N]. Replaces the
    full [N, L] leaf_contains sweep when only the winning leaf matters."""
    w2l, params = (_leaf_rows(scene, leaf_idx) if rows is None else rows)[:2]
    p_loc = vmath.transform_point(w2l, point)
    lt = _leaf_type_of(scene, leaf_idx)
    out = jnp.zeros(point.shape[:-1], bool)
    present = {t for t, _, _ in scene.type_slices}
    for tid, fn in _a.CONTAINS_FNS.items():
        if tid not in present:
            continue
        m = lt == tid
        safe = jnp.where(m[:, None], params, _SAFE_PARAMS[None, : params.shape[1]])
        out = jnp.where(m, fn(p_loc, safe), out)
    return out


def _leaf_normal(scene: CompiledScene, leaf_idx, p_local, params=None):
    """Local outward normal of the (gathered) winning leaf at p_local [N,3].

    Dynamic type dispatch via compute-all-and-select — 6 cheap closed forms
    on [N,3] data.
    """
    if params is None:
        params = vmath.select_rows(scene.leaf_params, leaf_idx)  # [N,PB]
    # leaf type per ray from the static type slices
    leaf_type = jnp.zeros_like(leaf_idx)
    for type_id, start, stop in scene.type_slices:
        leaf_type = jnp.where((leaf_idx >= start) & (leaf_idx < stop), type_id, leaf_type)
    n = jnp.zeros_like(p_local)
    present = {t for t, _, _ in scene.type_slices}
    for type_id, fn in _a.NORMAL_FNS.items():
        if type_id not in present:
            continue
        m = leaf_type == type_id
        # sanitize the param block on non-matching lanes: evaluating e.g.
        # the cone normal with a sphere's zero height would produce NaN in
        # the masked branch and leak through reverse-mode (double-where)
        safe_params = jnp.where(m[:, None], params, _SAFE_PARAMS[None, : params.shape[1]])
        cand = fn(p_local, safe_params)
        n = jnp.where(m[:, None], cand, n)
    return n


def intersect_scene(scene: CompiledScene, origin, direction, t_min_scale=None):
    """Nearest-hit query for a ray batch.

    origin/direction: f32[N,3] world space (direction unit length).
    Returns a HitRecord.
    """
    N = origin.shape[0]
    eps = T_EPS * jnp.maximum(
        1.0, jnp.max(jnp.abs(origin), axis=-1)
    )  # relative minimum advance [N]
    if t_min_scale is not None:
        eps = eps * t_min_scale

    E = scene.n_entities

    # running nearest-hit triple across all entity classes
    t_best = jnp.full((N,), _INF, origin.dtype)
    ent_best = jnp.full((N,), -1, jnp.int32)
    leaf_best = jnp.zeros((N,), jnp.int32)

    csg_leaf_ids = set()
    for _, leaf_ids, _ in scene.csg_entities:
        csg_leaf_ids.update(leaf_ids)

    csg_cand = {}  # global leaf id -> [N, K] candidates
    if scene.n_leaves:
        # Per-type streaming: each type slice's candidates fold into
        # per-entity minima IMMEDIATELY, so the full [N, L, K] crossing
        # tensor is never materialised in HBM. Only the few leaves owned by
        # CSG entities keep their K candidates for the boundary logic.
        t_entity = jnp.full((N, E), _INF, dtype=origin.dtype)
        leaf_entity_np = scene.leaf_entity
        for type_id, start, stop in scene.type_slices:
            w2l = scene.leaf_w2l[start:stop]  # [l,4,4]
            params = scene.leaf_params[start:stop]  # [l,PB]
            o_loc, d_loc = _rays_to_local(w2l, origin, direction)
            cand_slice = _a.CANDIDATE_FNS[type_id](o_loc, d_loc, params[None, :, :])
            # nearest positive crossing per leaf in this slice
            cand_pos = jnp.where(cand_slice > eps[:, None, None], cand_slice, _INF)
            t_leaf_slice = jnp.min(cand_pos, axis=-1)  # [N, l]
            simple_sel = [i for i in range(start, stop) if i not in csg_leaf_ids]
            if simple_sel:
                if len(simple_sel) == stop - start:
                    t_simple = t_leaf_slice
                    ent_ids = leaf_entity_np[start:stop]
                else:
                    local = jnp.asarray([i - start for i in simple_sel])
                    t_simple = t_leaf_slice[:, local]
                    ent_ids = leaf_entity_np[jnp.asarray(simple_sel)]
                t_entity = t_entity.at[:, ent_ids].min(t_simple)
            for g in range(start, stop):
                if g in csg_leaf_ids:
                    csg_cand[g] = cand_slice[:, g - start, :]
        # fold the per-entity minima into the running triple
        ent0 = jnp.argmin(t_entity, axis=-1).astype(jnp.int32)
        t0 = jnp.min(t_entity, axis=-1)
        simple_leaf = jnp.asarray(
            [max(i, 0) for i in scene.simple_leaf_of_entity], dtype=jnp.int32
        )
        leaf0 = vmath.select_rows(simple_leaf, ent0)
        fin0 = jnp.isfinite(t0)
        t_best = jnp.where(fin0, t0, t_best)
        ent_best = jnp.where(fin0, ent0, ent_best)
        leaf_best = jnp.where(fin0, leaf0, leaf_best)

    # per-ray bookkeeping for csg winners
    csg_t = []
    for e, leaf_ids, program in scene.csg_entities:
        inside_fn = _program_to_closure(program)
        ids = jnp.asarray(leaf_ids)
        tc = jnp.stack([csg_cand[g] for g in leaf_ids], axis=1)  # [N, l, K]
        l = len(leaf_ids)
        C = l * _a.MAX_HITS
        t_flat = tc.reshape(N, C)
        # local (0..l-1) leaf index per candidate slot
        local_leaf = jnp.broadcast_to(
            jnp.arange(l)[None, :, None], (N, l, _a.MAX_HITS)
        ).reshape(N, C)
        src_leaf = jnp.broadcast_to(ids[None, :, None], (N, l, _a.MAX_HITS)).reshape(N, C)
        # sort candidates by t — multi-operand lax.sort carries the leaf ids
        # through the sorting network instead of argsort + row gathers
        t_sorted, leaf_sorted, local_sorted = jax.lax.sort(
            (t_flat, src_leaf, local_leaf), dimension=-1, num_keys=1
        )
        finite = jnp.isfinite(t_sorted) & (t_sorted > eps[:, None])

        # EXACT per-leaf inside state at every crossing via crossing parity:
        # each valid crossing of a leaf toggles that leaf's containment, so
        # state-before-crossing-j = state-at-origin XOR parity(valid
        # crossings of that leaf strictly before j in the sorted order).
        # No positional epsilon probing (which mis-attributes boundaries
        # when surfaces are closer than the probe offset, e.g. a lens
        # barrel cap a few microns from the sphere vertex).
        onehot = (
            (local_sorted[..., None] == jnp.arange(l)[None, None, :])
            & finite[..., None]
        ).astype(jnp.int32)  # [N, C, l]
        cum_incl = jnp.cumsum(onehot, axis=1)
        cum_excl = cum_incl - onehot
        # leaf containment at the ray origin
        o_loc_parts = jnp.zeros((N, l), dtype=bool)
        for type_id, start, stop in scene.type_slices:
            sel = [i for i, g in enumerate(leaf_ids) if start <= g < stop]
            if not sel:
                continue
            g_ids = jnp.asarray([leaf_ids[i] for i in sel])
            w2l = scene.leaf_w2l[g_ids]
            params = scene.leaf_params[g_ids]
            p_loc = vmath.transform_point(w2l[None], origin[:, None, :])
            o_loc_parts = o_loc_parts.at[:, jnp.asarray(sel)].set(
                _a.CONTAINS_FNS[type_id](p_loc, params[None])
            )
        leaf_before = o_loc_parts[:, None, :] ^ (cum_excl % 2 == 1)  # [N, C, l]
        leaf_after = o_loc_parts[:, None, :] ^ (cum_incl % 2 == 1)
        inside_b = inside_fn(leaf_before)  # [N, C]
        inside_a = inside_fn(leaf_after)
        boundary = finite & (inside_b != inside_a)
        t_valid = jnp.where(boundary, t_sorted, _INF)
        # first-minimum one-hot select (no row gathers)
        bt = jnp.min(t_valid, axis=-1)
        is_min = t_valid <= bt[:, None]
        onehot = is_min & (jnp.cumsum(is_min, axis=-1) == 1)
        bleaf = jnp.sum(jnp.where(onehot, leaf_sorted, 0), axis=-1)
        binside = jnp.any(onehot & inside_b, axis=-1)
        better = bt < t_best
        t_best = jnp.where(better, bt, t_best)
        ent_best = jnp.where(better, e, ent_best)
        leaf_best = jnp.where(better, bleaf.astype(jnp.int32), leaf_best)
        csg_t.append((e, bt, bleaf, binside))

    # mesh entities: stackless BVH traversal in each mesh's local frame
    # (direction deliberately NOT renormalised so t shares world units).
    # Two or more small meshes merge into ONE world-space forest call
    # (mesh_forest_intersect): the per-mesh ray transforms fold into the
    # per-triangle tables and the union streams through one product. A lone
    # small mesh walks its BVH: for one mesh, dense is no faster end to end.
    mesh_win = []
    forest = []
    singles = []
    for e, slot in scene.mesh_entities:
        mesh = scene.meshes[slot]
        if mesh.triangles.shape[0] <= meshtrace.DENSE_TRI_LIMIT:
            forest.append((e, slot, mesh))
        else:
            singles.append((e, slot, mesh))
    if len(forest) == 1:
        singles.insert(0, forest.pop())
    if forest:
        results = mesh_forest_intersect(
            [m for _, _, m in forest], origin, direction, eps
        )
        for (e, slot, _), res in zip(forest, results):
            t_m = jnp.where(res["tri"] >= 0, res["t"], _INF)
            better = t_m < t_best
            t_best = jnp.where(better, t_m, t_best)
            ent_best = jnp.where(better, e, ent_best)
            mesh_win.append((e, slot, res))
    for e, slot, mesh in singles:
        o_loc = vmath.transform_point(mesh.w2l[None], origin)
        d_loc = vmath.transform_vector(mesh.w2l[None], direction)
        res = mesh_intersect(mesh, o_loc, d_loc, eps)
        t_m = jnp.where(res["tri"] >= 0, res["t"], _INF)
        better = t_m < t_best
        t_best = jnp.where(better, t_m, t_best)
        ent_best = jnp.where(better, e, ent_best)
        mesh_win.append((e, slot, res))

    # global nearest entity
    entity = ent_best
    t = t_best
    hit = jnp.isfinite(t) & (entity >= 0)
    t_safe = jnp.where(hit, t, 0.0)

    point = origin + t_safe[:, None] * direction
    delta = jnp.maximum(T_EPS, T_EPS * jnp.abs(t_safe))

    if scene.n_leaves:
        # winning leaf (tracked through the running triple; csg updates
        # already recorded their boundary leaf)
        leaf = leaf_best

        # one fused row select serves the normal, its transform AND the
        # containment test below
        rows = _leaf_rows(scene, leaf)
        w2l, leaf_params = rows[:2]

        # outward leaf normal at hit (local -> world with inverse-transpose)
        p_local = vmath.transform_point(w2l, point)
        n_local = _leaf_normal(scene, leaf, p_local, params=leaf_params)
        n_world = vmath.normalise(vmath.transform_normal(w2l, n_local))

        # solid-inside state before the crossing -> exiting flag + normal
        # sign. Only the WINNING leaf's containment matters, so test that
        # single gathered leaf instead of sweeping all L (the full [N, L]
        # sweep was the other linear-in-leaves HBM term).
        p_before = origin + (t_safe - delta)[:, None] * direction
        inside_before = _leaf_contains_single(scene, leaf, p_before, rows=rows)
    else:
        leaf = jnp.zeros((N,), jnp.int32)
        n_world = jnp.zeros_like(point)
        inside_before = jnp.zeros((N,), bool)
    for e, bt, bleaf, binside in csg_t:
        inside_before = jnp.where(entity == e, binside, inside_before)

    # mesh winners: smoothed (or face) normal, exiting from face orientation
    # (mesh.pyx:718-804 MeshIntersection semantics)
    win_tri = jnp.full((N,), -1, jnp.int32)
    win_u = jnp.zeros((N,), jnp.float32)
    win_v = jnp.zeros((N,), jnp.float32)
    for e, slot, res in mesh_win:
        mesh = scene.meshes[slot]
        m = (entity == e) & hit
        tri_idx = jnp.clip(res["tri"], 0, mesh.triangles.shape[0] - 1)
        tri = mesh.triangles[tri_idx]
        if mesh.smoothing:
            w0 = (1.0 - res["u"] - res["v"])[:, None]
            n_loc = (
                w0 * mesh.vertex_normals[tri[:, 0]]
                + res["u"][:, None] * mesh.vertex_normals[tri[:, 1]]
                + res["v"][:, None] * mesh.vertex_normals[tri[:, 2]]
            )
        else:
            n_loc = mesh.face_normals[tri_idx]
        n_w = vmath.normalise(vmath.transform_normal(mesh.w2l[None], n_loc))
        n_world = jnp.where(m[:, None], n_w, n_world)
        inside_before = jnp.where(m, ~res["front"], inside_before)
        win_tri = jnp.where(m, res["tri"], win_tri)
        win_u = jnp.where(m, res["u"], win_u)
        win_v = jnp.where(m, res["v"], win_v)

    # orient normal to point away from the solid: when exiting the solid the
    # outward normal must align with the ray direction, when entering oppose
    d_dot_n = vmath.dot(direction, n_world)
    want_align = inside_before  # exiting
    flip = jnp.where(want_align, d_dot_n < 0.0, d_dot_n > 0.0)
    n_world = jnp.where(flip[:, None], -n_world, n_world)

    # epsilon-displaced relaunch points (intersection.pyx:45-50)
    off = (T_EPS * jnp.maximum(1.0, jnp.max(jnp.abs(point), axis=-1)))[:, None]
    outside_point = point + n_world * off
    inside_point = point - n_world * off

    return HitRecord(
        hit=hit,
        t=t,
        entity=jnp.where(hit, entity, -1),
        leaf=leaf,
        point=point,
        normal=n_world,
        exiting=inside_before,
        inside_point=inside_point,
        outside_point=outside_point,
        tri=win_tri,
        bary_u=win_u,
        bary_v=win_v,
    )
