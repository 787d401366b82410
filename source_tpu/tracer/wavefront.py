"""Wavefront path-trace megakernel.

Vectorised replacement for the reference's recursive estimator
(optical/ray.pyx:338-455 ``trace``; material dispatch per SURVEY.md §3.2).
The recursion becomes an iterative loop over bounce depth with a ray-state
SoA; materials are evaluated branchlessly by masked select over material
type codes; Russian roulette, one-sample MIS (material.pyx:327-352), the
dielectric path roulette (dielectric.pyx:248-302) and volume responses
(Beer-Lambert dielectric.pyx:313-328, homogeneous emitters) all preserve the
reference's exact estimator so images converge to the same answer.

Two drivers share the step body:
  * ``trace_rays`` — ``lax.while_loop`` that exits when every ray has
    terminated (fast forward rendering);
  * ``trace_rays_diff`` — fixed-length ``lax.scan`` with rematerialised steps
    (reverse-mode differentiable w.r.t. the CompiledScene pytree).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..compiler.scene import CompiledScene
from ..core.math import batch as vmath
from ..core.math import random as vrand
from ..optical.material.base import (
    MAT_ABSORBER,
    MAT_CHECKERBOARD,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DISCRETE_BSDF,
    MAT_EMITTER,
    MAT_EMITTER_ANISO,
    MAT_LAMBERT,
    MAT_LIGHT,
    MAT_NULL,
    MAT_PERFECT_REFLECT,
    MAT_ROUGH_CONDUCTOR,
    ROUGHEN_SLOT,
    VOL_BEER,
    VOL_HOMOGENEOUS,
    VOL_INHOMOGENEOUS,
)
from ..compiler.scene import _program_to_closure
from ..primitive import analytic as _a
from .intersect import HitRecord, entity_contains, intersect_scene

__all__ = ["RayConfig", "RayState", "init_rays", "trace_rays", "trace_rays_diff",
           "trace_rays_logged", "reconstruct_trajectories", "alive_profile",
           "schedule_from_profile"]

_INF = jnp.inf
_PI = jnp.pi


@dataclasses.dataclass(frozen=True)
class RayConfig:
    """Static per-render ray parameters (optical/ray.pyx:85-126 defaults)."""

    max_depth: int = 32
    extinction_prob: float = 0.1
    extinction_min_depth: int = 3
    importance_sampling: bool = True
    important_path_weight: float = 0.25
    max_iters: int = 256  # wavefront loop bound (null hops excluded from depth)
    # per-segment hit-distance bound (core/ray.pyx:38 Ray.max_distance;
    # daughters inherit it, optical/ray.pyx:528)
    max_distance: float = float("inf")
    # differentiable-scan stream compaction: ((steps, shrink_divisor), ...)
    # — after `steps` bounces, sort alive-first and keep N/divisor lanes.
    # Empty = off (required under a sharded batch axis).
    compact_schedule: tuple = ()
    # trace_rays loop style: True = while_loop that exits when every lane
    # is dead; False = fori_loop with no per-iteration alive reduction —
    # better when compaction already bounds the tail or extinction is low
    # (reference default 0.01 keeps most lanes alive to max_depth anyway)
    early_exit: bool = True
    # reverse-mode rematerialisation granularity: bounces per checkpoint
    # block in trace_rays_diff. 1 (default) = the classic per-bounce
    # checkpoint. Larger blocks store the carry only at block boundaries
    # and recompute the inner bounces in the backward pass — bytes /
    # block_size at ~2x block compute, a win only when the trace is
    # memory-bandwidth-bound. Not measured on the H100 yet.
    remat_block: int = 1
    # storage dtype for the spectral path state (throughput/radiance and
    # the [N, B] material intermediates feeding them): "float32" (default,
    # bit-faithful to the reference estimator) or "bfloat16" (halves the
    # dominant per-bounce HBM traffic; all reductions/compares still run
    # in f32 via promotion, only the stored state rounds — the added
    # rounding noise is measured against MC noise in
    # tests/test_bf16_state.py; its speed is not measured on the H100 yet)
    spectral_dtype: str = "float32"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RayState:
    origin: Any  # f32[N,3]
    direction: Any  # f32[N,3]
    throughput: Any  # f32[N,B]
    radiance: Any  # f32[N,B]
    alive: Any  # bool[N]
    depth: Any  # i32[N]
    segments: Any  # i32[] total path segments traced (rays/s accounting)
    # i32[] alive lanes beyond a compaction stage's capacity, summed over
    # stages — each adds roulette variance (not bias); nonzero says the
    # compact_schedule divisors are too aggressive for this scene
    overflow: Any


def init_rays(origin, direction, bins, weight=None, spectral_dtype=None):
    """Fresh ray state for a batch of camera rays."""
    N = origin.shape[0]
    sdt = jnp.dtype(spectral_dtype) if spectral_dtype else origin.dtype
    throughput = jnp.ones((N, bins), sdt)
    if weight is not None:
        throughput = throughput * weight[:, None].astype(sdt)
    return RayState(
        origin=origin,
        direction=direction,
        throughput=throughput,
        radiance=jnp.zeros((N, bins), sdt),
        alive=jnp.ones(N, dtype=bool),
        depth=jnp.zeros(N, dtype=jnp.int32),
        segments=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
    )


# --- importance sampling (optical/scenegraph/world.pyx:134-253) -----------------


def _important_cone(scene: CompiledScene, point):
    """Per-sphere cone geometry from a point: axis[N,I,3], cos_max[N,I]."""
    to_c = scene.imp_centre[None, :, :] - point[:, None, :]  # [N,I,3]
    dist2 = jnp.sum(to_c * to_c, axis=-1)
    dist = jnp.sqrt(dist2 + 1e-12)
    axis = to_c / dist[..., None]
    r = scene.imp_radius[None, :]
    inside = dist <= r
    sin2 = jnp.clip((r / dist) ** 2, 0.0, 1.0)
    c2 = 1.0 - sin2
    ok = c2 > 0.0
    cos_max = jnp.where(ok, jnp.sqrt(jnp.where(ok, c2, 1.0)), 0.0)
    # origin inside the sphere -> sample the full sphere (cos_max = -1)
    cos_max = jnp.where(inside, -1.0, cos_max)
    return axis, cos_max


def important_direction_sample(scene: CompiledScene, point, u):
    """Sample a direction toward an important primitive
    (world.pyx:155-198). ``u`` is [N,3] uniforms."""
    axis, cos_max = _important_cone(scene, point)
    # pick sphere by cdf
    idx = jnp.searchsorted(scene.imp_cdf, u[:, 0], side="left")
    idx = jnp.clip(idx, 0, scene.imp_cdf.shape[0] - 1)
    # one-hot row pick over the small sphere axis
    onehot = idx[:, None] == jnp.arange(scene.imp_cdf.shape[0])[None, :]
    ax = jnp.sum(jnp.where(onehot[..., None], axis, 0.0), axis=1)
    cm = jnp.sum(jnp.where(onehot, cos_max, 0.0), axis=1)
    local = vrand.vector_cone_uniform(u[:, 1], u[:, 2], cm)
    t, b, n = vmath.make_frame(ax)
    return vmath.from_frame(local, t, b, n)


def important_direction_pdf(scene: CompiledScene, point, direction):
    """Mixture pdf over all important spheres (world.pyx:203-253)."""
    axis, cos_max = _important_cone(scene, point)
    c = jnp.sum(axis * direction[:, None, :], axis=-1)  # [N,I]
    solid = 2.0 * _PI * (1.0 - cos_max)
    pdf_i = jnp.where(c >= cos_max, 1.0 / jnp.maximum(solid, 1e-12), 0.0)
    return jnp.sum(scene.imp_weight[None, :] * pdf_i, axis=-1)


# --- material helpers ------------------------------------------------------------


def _conductor_fresnel(ci, n, k):
    """Spectral Fresnel reflectivity for a conducting interface
    (conductor.pyx:77-149). ci [N,1] |cos|, n/k [N,B]."""
    ci2 = ci * ci
    n2k2 = n * n + k * k
    two_n_ci = 2.0 * n * ci
    rs = (n2k2 - two_n_ci + ci2) / jnp.maximum(n2k2 + two_n_ci + ci2, 1e-30)
    rp_num = n2k2 * ci2 - two_n_ci + 1.0
    rp_den = n2k2 * ci2 + two_n_ci + 1.0
    rp = rp_num / jnp.maximum(rp_den, 1e-30)
    return 0.5 * (rs + rp)


def _ggx_sample(u1, u2, rough):
    """Sample a GGX half-vector in the +z frame.

    The reference parameterises GGX with alpha = roughness
    (conductor.pyx:229-236: theta = atan(roughness*sqrt(e1)/sqrt(1-e1))),
    NOT the Disney alpha = roughness^2 remap."""
    a2 = rough * rough
    phi = 2.0 * _PI * u2
    ct2 = jnp.clip((1.0 - u1) / jnp.maximum(1.0 + (a2 - 1.0) * u1, 1e-12), 0.0, 1.0)
    ct = jnp.sqrt(ct2 + 1e-12)
    st = jnp.sqrt(jnp.clip(1.0 - ct2, 1e-12, 1.0))
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def _ggx_d(ct_h, rough):
    """GGX normal distribution with alpha = roughness (conductor.pyx:288-296)."""
    a2 = rough * rough
    d = ct_h * ct_h * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(_PI * d * d, 1e-12)


def _smith_g1(ct, rough):
    """Smith G1 with alpha = roughness (conductor.pyx:302-306)."""
    a2 = rough * rough
    return 2.0 * ct / jnp.maximum(ct + jnp.sqrt(a2 + (1.0 - a2) * ct * ct), 1e-12)


# --- the step body -----------------------------------------------------------------


def _surface_interaction(scene: CompiledScene, cfg: RayConfig, state: RayState,
                         rec: HitRecord, u):
    """Evaluate all surface material responses for the ray batch and return
    (new_origin, new_direction, throughput_mul[N,B], emission[N,B],
    continues[N], counts_depth[N])."""
    N = state.origin.shape[0]
    B = state.throughput.shape[1]
    dtype = state.origin.dtype

    mat_id = vmath.select_rows(scene.entity_material, jnp.maximum(rec.entity, 0))

    # mix modifiers (Blend/Add): reroll the material id before gathering.
    # Remaps are sorted ascending so nested mixes resolve in one sweep;
    # Add lanes get a 2x one-sample compensation weight (modifiers.py).
    lane_weight = jnp.ones((N,), dtype)
    for mix_id, id_a, id_b, add_weight in scene.mix_remaps:
        ratio = scene.mat_params[mix_id, 0]
        pick_b = u[:, 7] < ratio
        is_mix = mat_id == mix_id
        mat_id = jnp.where(is_mix, jnp.where(pick_b, id_b, id_a), mat_id)
        if add_weight != 1.0:
            lane_weight = jnp.where(is_mix, lane_weight * add_weight, lane_weight)

    mat_types = vmath.select_rows(jnp.asarray(scene.mat_types, jnp.int32), mat_id)  # [N]
    # the built-in dispatch only reads spectral slots 0-1; gathering the
    # full NSLOTS=4 table doubles the dominant [N, slots, B] per-bounce
    # traffic, so the tail slots ride along only for user BSDFs
    n_slots = scene.mat_spectra.shape[1] if scene.custom_materials else 2
    spectra = vmath.select_rows(scene.mat_spectra[:, :n_slots], mat_id)  # [N, n_slots, B]
    params = vmath.select_rows(scene.mat_params, mat_id)  # [N, NPARAMS]
    scalars = vmath.select_rows(scene.mat_scalars, mat_id)  # [N, NSCALARS]

    d = state.direction
    n = rec.normal  # outward solid normal
    cos_in = -vmath.dot(d, n)  # >0 when hitting the front/outside face
    # shading normal faces the incident ray (ContinuousBSDF normal flip)
    n_sh = jnp.where(cos_in[:, None] >= 0.0, n, -n)

    # Roughen modifier: perturb the shading normal pre-dispatch
    # (roughen.pyx:46-120 — lerp toward a cosine-hemisphere sample,
    # rejection-accepting perturbations that keep the incident ray on the
    # same side). The reference retries up to 50 times; here 4 vectorized
    # attempts take the first valid draw (acceptance probability is high,
    # so the residual fallback-to-unperturbed mass is p_reject^4 — the
    # divergence is pinned by tests/test_roughen_estimator.py)
    roughen = params[:, ROUGHEN_SLOT]
    if scene.has_roughen:
        t_r, b_r, n_r = vmath.make_frame(n_sh)
        chosen = n_sh
        found = jnp.zeros(N, dtype=bool)
        for a in range(4):
            pert = vmath.from_frame(
                vrand.vector_hemisphere_cosine(u[:, 8 + 2 * a], u[:, 9 + 2 * a]),
                t_r, b_r, n_r,
            )
            n_pert = vmath.normalise(vmath.lerp(n_sh, pert, roughen[:, None]))
            # valid when the perturbed normal stays on the incident side and
            # faces away from the ray; cos_in stays geometric (the
            # dielectric's entering/exiting logic needs the true normal)
            valid = (vmath.dot(n_pert, n_sh) > 1e-4) & (
                vmath.dot(d, n_pert) < 0.0
            )
            take = valid & ~found
            chosen = jnp.where(take[:, None], n_pert, chosen)
            found = found | valid
        keep = found & (roughen > 0.0)
        n_sh = jnp.where(keep[:, None], chosen, n_sh)
    abs_cos_in = jnp.abs(cos_in)

    # surface frame for hemisphere sampling
    t_f, b_f, n_f = vmath.make_frame(n_sh)

    # reflection/transmission launch origins relative to the incident side
    front = cos_in >= 0.0
    refl_origin = jnp.where(front[:, None], rec.outside_point, rec.inside_point)
    trans_origin = jnp.where(front[:, None], rec.inside_point, rec.outside_point)

    new_origin = refl_origin
    new_direction = d
    thr_mul = jnp.zeros((N, B), dtype)
    emission = jnp.zeros((N, B), dtype)
    continues = jnp.zeros(N, dtype=bool)
    counts_depth = jnp.ones(N, dtype=bool)

    present = set(scene.mat_types)

    # --- emitters (terminal) ----------------------------------------------------
    if MAT_EMITTER in present:
        m = mat_types == MAT_EMITTER
        emission = jnp.where(m[:, None], spectra[:, 0, :], emission)
    if MAT_EMITTER_ANISO in present:
        m = mat_types == MAT_EMITTER_ANISO
        power = params[:, 0]
        base = jnp.maximum(jnp.abs(cos_in), 1e-9)
        factor = base ** power
        emission = jnp.where(m[:, None], spectra[:, 0, :] * factor[:, None], emission)
    if MAT_CHECKERBOARD in present:
        m = mat_types == MAT_CHECKERBOARD
        width = jnp.maximum(params[:, 0], 1e-12)
        # checker parity in the ENTITY's local space (checkerboard.pyx:39 —
        # the pattern frame is the primitive's own, not a CSG child leaf's)
        w2l = vmath.select_rows(scene.entity_w2l, jnp.maximum(rec.entity, 0))
        p_loc = vmath.transform_point(w2l, rec.point)
        cells = jnp.floor(p_loc / width[:, None]).astype(jnp.int32)
        parity = (cells[:, 0] + cells[:, 1] + cells[:, 2]) % 2 == 0
        emis = jnp.where(parity[:, None], spectra[:, 0, :], spectra[:, 1, :])
        emission = jnp.where(m[:, None], emis, emission)

    # --- debug Light: distant-source lambertian response (debug.pyx:41) ---------
    if MAT_LIGHT in present:
        m = mat_types == MAT_LIGHT
        ldir = params[:, 0:3]  # world-space, unit
        fac = jnp.maximum(0.0, -jnp.sum(ldir * n_sh, axis=-1))
        emission = jnp.where(m[:, None], spectra[:, 0, :] * fac[:, None], emission)

    # --- debug PerfectReflectingSurface: lossless mirror (debug.pyx:82) ---------
    if MAT_PERFECT_REFLECT in present:
        m = mat_types == MAT_PERFECT_REFLECT
        refl_dir = vmath.reflect(d, n_sh)
        thr_mul = jnp.where(m[:, None], 1.0, thr_mul)
        new_direction = jnp.where(m[:, None], refl_dir, new_direction)
        new_origin = jnp.where(m[:, None], refl_origin, new_origin)
        continues = continues | m

    # --- null surface: pass through, depth exempt (material.pyx:118-160) --------
    if MAT_NULL in present:
        m = mat_types == MAT_NULL
        continues = continues | m
        counts_depth = jnp.where(m, False, counts_depth)
        new_origin = jnp.where(m[:, None], trans_origin, new_origin)
        thr_mul = jnp.where(m[:, None], 1.0, thr_mul)

    # --- lambert with one-sample MIS ---------------------------------------------
    if MAT_LAMBERT in present:
        m = mat_types == MAT_LAMBERT
        dir_bsdf = vmath.from_frame(
            vrand.vector_hemisphere_cosine(u[:, 1], u[:, 2]), t_f, b_f, n_f
        )
        use_mis = cfg.importance_sampling and scene.has_importance
        if use_mis:
            w_imp = cfg.important_path_weight
            pick_light = u[:, 0] < w_imp
            dir_light = important_direction_sample(scene, rec.point, u[:, 3:6])
            out_dir = jnp.where(pick_light[:, None], dir_light, dir_bsdf)
            pdf_light = important_direction_pdf(scene, rec.point, out_dir)
            cos_out = vmath.dot(out_dir, n_sh)
            pdf_bsdf = jnp.maximum(cos_out, 0.0) / _PI
            pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
        else:
            out_dir = dir_bsdf
            cos_out = vmath.dot(out_dir, n_sh)
            pdf_bsdf = jnp.maximum(cos_out, 0.0) / _PI
            pdf = pdf_bsdf
        ok = m & (pdf > 1e-9) & (cos_out > 0.0)
        # estimator: reflectivity * pdf_cosine / pdf  (lambert.pyx:92-106)
        w_l = jnp.where(ok, pdf_bsdf / jnp.maximum(pdf, 1e-12), 0.0)
        thr_mul = jnp.where(m[:, None], spectra[:, 0, :] * w_l[:, None], thr_mul)
        new_direction = jnp.where(m[:, None], out_dir, new_direction)
        new_origin = jnp.where(m[:, None], refl_origin, new_origin)
        continues = continues | ok

    # --- smooth conductor: mirror + spectral Fresnel (conductor.pyx:77-149) ------
    if MAT_CONDUCTOR in present:
        m = mat_types == MAT_CONDUCTOR
        refl_dir = vmath.reflect(d, n_sh)
        f = _conductor_fresnel(abs_cos_in[:, None], spectra[:, 0, :], spectra[:, 1, :])
        thr_mul = jnp.where(m[:, None], f, thr_mul)
        new_direction = jnp.where(m[:, None], refl_dir, new_direction)
        new_origin = jnp.where(m[:, None], refl_origin, new_origin)
        continues = continues | m

    # --- rough conductor: GGX + Smith + conducting Fresnel (conductor.pyx:159) ---
    # RoughConductor is a ContinuousBSDF in the reference, so it carries the
    # one-sample MIS branch (material.pyx:327-352): with prob w sample a
    # light direction, else the GGX half-vector lobe; normalise by the
    # mixture pdf. pdf_ggx = D(h)·|h.z| / (4·|wo.h|) (conductor.pyx:202-221).
    if MAT_ROUGH_CONDUCTOR in present:
        m = mat_types == MAT_ROUGH_CONDUCTOR
        rough = jnp.clip(params[:, 0], 1e-3, 1.0)
        h_local = _ggx_sample(u[:, 1], u[:, 2], rough)
        h_bsdf = vmath.from_frame(h_local, t_f, b_f, n_f)
        wi = -d
        wo_bsdf = vmath.reflect(d, h_bsdf)
        use_mis = cfg.importance_sampling and scene.has_importance
        if use_mis:
            w_imp = cfg.important_path_weight
            pick_light = u[:, 0] < w_imp
            dir_light = important_direction_sample(scene, rec.point, u[:, 3:6])
            wo = jnp.where(pick_light[:, None], dir_light, wo_bsdf)
        else:
            wo = wo_bsdf
        # half-vector of the realised direction pair (conductor.pyx:205-215)
        h_raw = wi + wo
        h_len = jnp.sqrt(jnp.maximum(vmath.dot(h_raw, h_raw), 1e-24))
        h = h_raw / h_len[:, None]
        ct_i = jnp.maximum(vmath.dot(wi, n_sh), 1e-6)
        ct_o = vmath.dot(wo, n_sh)
        ct_h = vmath.dot(h, n_sh)
        o_dot_h = vmath.dot(wo, h)
        d_ggx = _ggx_d(ct_h, rough)
        pdf_bsdf = 0.25 * d_ggx * jnp.abs(
            ct_h / jnp.where(jnp.abs(o_dot_h) > 1e-9, o_dot_h, 1e-9)
        )
        if use_mis:
            pdf_light = important_direction_pdf(scene, rec.point, wo)
            pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
        else:
            pdf = pdf_bsdf
        ok = m & (ct_o > 1e-6) & (pdf > 1e-9)
        # Fresnel at the microfacet: ci = h.wo (conductor.pyx:324-331)
        f = _conductor_fresnel(
            jnp.abs(o_dot_h)[:, None], spectra[:, 0, :], spectra[:, 1, :]
        )
        g = _smith_g1(ct_i, rough) * _smith_g1(jnp.maximum(ct_o, 1e-6), rough)
        # estimator: [D·G·F / (4·cos_i)] / pdf  (evaluate_shading × div_scalar)
        w_spec = jnp.where(ok, d_ggx * g / (4.0 * ct_i * jnp.maximum(pdf, 1e-12)), 0.0)
        thr_mul = jnp.where(m[:, None], f * w_spec[:, None], thr_mul)
        new_direction = jnp.where(m[:, None], wo, new_direction)
        new_origin = jnp.where(m[:, None], refl_origin, new_origin)
        continues = continues | ok

    # --- dielectric: Snell + Fresnel path roulette (dielectric.pyx:165-302) ------
    if MAT_DIELECTRIC in present:
        m = mat_types == MAT_DIELECTRIC
        # sanitize indices on non-dielectric lanes (their scalars are zero;
        # 0/0 would NaN the masked branch through reverse-mode)
        n_int = jnp.where(m, jnp.maximum(scalars[:, 0], 1e-3), 1.5)
        n_ext = jnp.where(m, jnp.maximum(scalars[:, 1], 1e-3), 1.0)
        transmission_only = params[:, 0] > 0.5
        # c1 follows the reference sign convention: n is the true outward
        # normal, c1 = -n.d (>0 entering)
        c1 = cos_in
        entering = c1 >= 0.0
        n1 = jnp.where(entering, n_ext, n_int)
        n2 = jnp.where(entering, n_int, n_ext)
        gamma = n1 / n2
        c2s = 1.0 - gamma * gamma * (1.0 - c1 * c1)
        tir = c2s <= 0.0
        sq = jnp.where(~tir, jnp.sqrt(jnp.where(~tir, c2s, 1.0)), 0.0)
        temp_t = jnp.where(entering, gamma * c1 - sq, gamma * c1 + sq)
        trans_dir = vmath.normalise(gamma[:, None] * d + temp_t[:, None] * n)
        refl_dir = vmath.reflect(d, n)
        c2 = -vmath.dot(n, trans_dir)
        # fresnel (dielectric.pyx:304-308)
        r1 = (n1 * c1 - n2 * c2) / jnp.where(jnp.abs(n1 * c1 + n2 * c2) > 1e-12, n1 * c1 + n2 * c2, 1e-12)
        r2 = (n1 * c2 - n2 * c1) / jnp.where(jnp.abs(n1 * c2 + n2 * c1) > 1e-12, n1 * c2 + n2 * c1, 1e-12)
        reflectivity = 0.5 * (r1 * r1 + r2 * r2)
        transmit = transmission_only | (u[:, 0] < (1.0 - reflectivity))
        transmit = jnp.where(tir, False, transmit)
        dead_tir = tir & transmission_only
        # path weights cancel (roulette prob == coefficient)
        out_dir = jnp.where(transmit[:, None], trans_dir, refl_dir)
        # launch side: transmitted rays continue beyond the surface,
        # reflected rays stay on the incident side
        origin_sel = jnp.where(transmit[:, None], trans_origin, refl_origin)
        ok = m & ~dead_tir
        thr_mul = jnp.where(m[:, None], jnp.where(ok[:, None], 1.0, 0.0), thr_mul)
        new_direction = jnp.where(m[:, None], out_dir, new_direction)
        new_origin = jnp.where(m[:, None], origin_sel, new_origin)
        continues = continues | ok

    # --- user-extensible BSDFs (material.pyx:205-390 extension point) ------------
    if scene.custom_materials:
        lam = scene.wavelengths.astype(dtype)  # traced bin centres
        w_in = vmath.to_frame(-d, t_f, b_f, n_f)  # points away from surface
        back_face = ~front  # reference 'exiting'/back_face flag (material.pyx:284)
        for cid, mat_obj in scene.custom_materials:
            m = mat_id == cid
            # sanitize lane-gathered inputs: other materials' spectra/param
            # rows ride the masked lanes, and a user singularity there (e.g.
            # divide by a zero param) NaNs reverse-mode through jnp.where
            # (same double-where hazard the dielectric branch guards)
            spectra_s = jnp.where(m[:, None, None], spectra, 1.0)
            params_s = jnp.where(m[:, None], params, 1.0)
            if mat_obj.MAT_TYPE == MAT_DISCRETE_BSDF:
                wo_local, weight, transmitted = mat_obj.evaluate_shading(
                    w_in, u[:, 1:3], lam, spectra_s, params_s, back_face
                )
                wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                ok = m & (jnp.max(weight, axis=-1) > 0.0)
                thr_mul = jnp.where(m[:, None], weight, thr_mul)
                new_direction = jnp.where(m[:, None], wo, new_direction)
                new_origin = jnp.where(
                    m[:, None],
                    jnp.where(transmitted[:, None], trans_origin, refl_origin),
                    new_origin,
                )
                continues = continues | ok
            else:  # ContinuousBSDF: one-sample MIS (material.pyx:327-352)
                wo_bsdf_local = mat_obj.sample(
                    w_in, u[:, 1], u[:, 2], spectra_s, params_s, back_face
                )
                use_mis = cfg.importance_sampling and scene.has_importance
                if use_mis:
                    w_imp = cfg.important_path_weight
                    pick_light = u[:, 0] < w_imp
                    dir_light = important_direction_sample(scene, rec.point, u[:, 3:6])
                    light_local = vmath.to_frame(dir_light, t_f, b_f, n_f)
                    wo_local = jnp.where(
                        pick_light[:, None], light_local, wo_bsdf_local
                    )
                    wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                    pdf_light = important_direction_pdf(scene, rec.point, wo)
                    pdf_bsdf = mat_obj.pdf(w_in, wo_local, spectra_s, params_s, back_face)
                    pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
                else:
                    wo_local = wo_bsdf_local
                    wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                    pdf = mat_obj.pdf(w_in, wo_local, spectra_s, params_s, back_face)
                cos_out = wo_local[:, 2]
                f = mat_obj.bsdf(w_in, wo_local, lam, spectra_s, params_s, back_face)
                # transmissive lanes (cos_out < 0) relaunch on the far side
                # of the surface (the reference hands w_transmission_origin
                # to evaluate_shading, material.pyx:286-361); weight uses
                # |cos_out| so below-hemisphere responses are not killed
                ok = m & (pdf > 1e-9) & (jnp.abs(cos_out) > 1e-9)
                w_c = jnp.where(ok, jnp.abs(cos_out) / jnp.maximum(pdf, 1e-12), 0.0)
                thr_mul = jnp.where(m[:, None], f * w_c[:, None], thr_mul)
                new_direction = jnp.where(m[:, None], wo, new_direction)
                new_origin = jnp.where(
                    m[:, None],
                    jnp.where(cos_out[:, None] < 0.0, trans_origin, refl_origin),
                    new_origin,
                )
                continues = continues | ok

    # absorbers fall through: continues stays False, thr_mul 0
    # Add-modifier one-sample compensation applies to the whole response
    thr_mul = thr_mul * lane_weight[:, None]
    emission = emission * lane_weight[:, None]
    return new_origin, new_direction, thr_mul, emission, continues, counts_depth


def _static_leaf_type(scene: CompiledScene, g):
    """Analytic type of a STATIC leaf index from the type slices."""
    for type_id, start, stop in scene.type_slices:
        if start <= g < stop:
            return type_id
    raise IndexError(f"leaf {g} outside type slices")


def _entity_inside(scene: CompiledScene, e, point):
    """Containment of ONE entity at point[N,3], testing only ITS OWN leaves
    with static table rows. The volume stage previously swept every leaf in
    the scene per bounce (entity_contains) — linear-in-L HBM traffic that
    only the handful of volume-active entities needed."""
    for ce, leaf_ids, program in scene.csg_entities:
        if ce == e:
            cols = []
            for g in leaf_ids:
                tid = _static_leaf_type(scene, g)
                p_loc = vmath.transform_point(scene.leaf_w2l[g][None], point)
                cols.append(
                    _a.CONTAINS_FNS[tid](p_loc, scene.leaf_params[g][None])
                )
            return _program_to_closure(program)(jnp.stack(cols, axis=-1))
    g = scene.simple_leaf_of_entity[e]
    if g >= 0:
        tid = _static_leaf_type(scene, g)
        p_loc = vmath.transform_point(scene.leaf_w2l[g][None], point)
        return _a.CONTAINS_FNS[tid](p_loc, scene.leaf_params[g][None])
    for me, slot in scene.mesh_entities:
        if me == e:
            mesh = scene.meshes[slot]
            if not mesh.closed:
                return jnp.zeros(point.shape[:-1], bool)
            from .meshtrace import mesh_intersect as _mi
            o_loc = vmath.transform_point(mesh.w2l[None], point)
            d_loc = vmath.transform_vector(
                mesh.w2l[None],
                jnp.broadcast_to(
                    jnp.asarray([0.0, 0.0, 1.0], point.dtype), point.shape
                ),
            )
            res = _mi(mesh, o_loc, d_loc, jnp.zeros(point.shape[0], point.dtype))
            return (res["tri"] >= 0) & ~res["front"]
    return jnp.zeros(point.shape[:-1], bool)


def _volume_interaction(scene: CompiledScene, state: RayState, rec: HitRecord):
    """Apply volume responses along the traversed segment
    (optical/ray.pyx:422-455). Static unrolled loop over volume-active
    entities; containment tested at the segment midpoint."""
    if not scene.volume_entities:
        return state.throughput, jnp.zeros_like(state.radiance)
    t_seg = jnp.where(rec.hit, rec.t, 0.0)
    midpoint = state.origin + 0.5 * t_seg[:, None] * state.direction
    throughput = state.throughput
    emission = jnp.zeros_like(state.radiance)
    for e, mat_idx, kind, mat_obj, leaf_idx, mesh_slot, intervals in scene.volume_entities:
        m = _entity_inside(scene, e, midpoint) & rec.hit
        spec = scene.mat_spectra[mat_idx]  # [NSLOTS, B]
        if kind == VOL_BEER:
            # transmission^length (dielectric.pyx:313-328); safe_pow keeps
            # gradients finite at zero transmission
            base = spec[1][None, :]
            ok = base > 1e-9
            att = jnp.where(ok, jnp.where(ok, base, 1.0) ** t_seg[:, None], 0.0)
            throughput = jnp.where(m[:, None], throughput * att, throughput)
        elif kind == VOL_HOMOGENEOUS:
            emission = emission + jnp.where(
                m[:, None], spec[0][None, :] * t_seg[:, None], 0.0
            )
        elif kind == VOL_INHOMOGENEOUS:
            # trapezoid-rule ray march of the emission closure in the
            # ENTITY's own local frame (emitter/inhomogeneous.pyx:108-177).
            # ``intervals`` is static, derived at scene-compile time from
            # the reference's step rule at the chord upper bound; each
            # segment is sampled at intervals+1 equally spaced points
            # including both endpoints (the reference adjusts its step to
            # absorb the remainder the same way, :139).
            # unwrap delegating modifiers (VolumeTransform) to the emitter
            inner = mat_obj
            while not hasattr(inner, "integrator") and hasattr(inner, "material"):
                inner = inner.material
            w2l_m = scene.entity_w2l[e]
            frame_extra = getattr(mat_obj, "volume_frame_matrix", None)
            S = intervals + 1
            ts = jnp.arange(S, dtype=t_seg.dtype) / intervals  # 0..1 incl.
            pts = (
                state.origin[:, None, :]
                + (ts[None, :] * t_seg[:, None])[..., None]
                * state.direction[:, None, :]
            )  # [N, S, 3]
            p_loc = vmath.transform_point(w2l_m[None, None], pts)
            d_loc = vmath.transform_vector(w2l_m[None], state.direction)
            if frame_extra is not None:
                fm = jnp.asarray(frame_extra(), p_loc.dtype)
                p_loc = vmath.transform_point(fm[None, None], p_loc)
                d_loc = vmath.transform_vector(fm[None], d_loc)
            # local-space integration measure (reference integrates the
            # local-frame length; differs from t_seg under scaling)
            d_norm = jnp.sqrt(jnp.maximum(vmath.dot(d_loc, d_loc), 1e-24))
            local_len = t_seg * d_norm
            d_unit = d_loc / d_norm[:, None]
            lam = scene.wavelengths.astype(t_seg.dtype)  # traced bin centres
            dens = inner.emission_function(p_loc, d_unit[:, None, :], lam)  # [N, S, B]
            w_trap = jnp.full((S,), 1.0, dens.dtype).at[0].set(0.5).at[-1].set(0.5)
            integral = (local_len / intervals)[:, None] * jnp.sum(
                dens * w_trap[None, :, None], axis=1
            )
            emission = emission + jnp.where(m[:, None], integral, 0.0)
    return throughput, emission


def _n_uniforms(scene: CompiledScene):
    """Uniform draws per bounce: 10, +6 when a Roughen modifier is present
    (its 4-attempt rejection sampling consumes columns 8..15)."""
    return 16 if scene.has_roughen else 10


def trace_step(scene: CompiledScene, cfg: RayConfig, state: RayState, step_key,
               u=None):
    """One wavefront bounce. Returns the next RayState.

    ``u`` optionally supplies this bounce's [N, n_uniforms] random draws
    (the drivers hoist the whole span's RNG into one upfront kernel instead
    of re-entering threefry inside every loop iteration)."""
    N = state.origin.shape[0]
    if u is None:
        u = jax.random.uniform(step_key, (N, _n_uniforms(scene)),
                               state.origin.dtype)

    # Russian roulette (optical/ray.pyx:380-388)
    roulette_active = state.alive & (state.depth >= cfg.extinction_min_depth)
    killed = roulette_active & (u[:, 6] < cfg.extinction_prob)
    survive_scale = jnp.where(
        roulette_active & ~killed, 1.0 / (1.0 - cfg.extinction_prob), 1.0
    )
    alive = state.alive & ~killed & (state.depth < cfg.max_depth)
    throughput = state.throughput * survive_scale[:, None]

    # park dead lanes far outside every bounding volume: a dead ray keeps
    # its last origin/direction, and re-traversing that stale path every
    # iteration keeps the mesh BVH walk visiting nodes for lanes that no
    # longer matter. Parked lanes fail the root slab test immediately. All downstream state updates are gated on
    # ``alive & rec.hit`` so their (miss) records never propagate.
    park = jnp.asarray([3.0e7, 3.0e7, 3.0e7], state.origin.dtype)
    origin_q = jnp.where(alive[:, None], state.origin, park)
    rec = intersect_scene(scene, origin_q, state.direction)
    if cfg.max_distance != float("inf"):
        # hits beyond the ray's terminating distance are misses
        # (core/ray.pyx:38 semantics, enforced by every accelerator hit)
        rec = dataclasses.replace(rec, hit=rec.hit & (rec.t <= cfg.max_distance))

    # volume stage over the traversed segment. Volume emission originates
    # within the segment so it is weighted by the segment-start throughput;
    # Beer-Lambert attenuation applies to everything arriving from beyond the
    # segment (the surface response below). Exact for media that either
    # attenuate or emit (reference NumericalIntegrator handles the mixed
    # case by marching; see emitter/inhomogeneous.pyx:108-177).
    thr_start = throughput
    vol_state = RayState(
        origin=state.origin,
        direction=state.direction,
        throughput=throughput,
        radiance=state.radiance,
        alive=alive,
        depth=state.depth,
        segments=state.segments,
        overflow=state.overflow,
    )
    throughput, vol_emission = _volume_interaction(scene, vol_state, rec)
    radiance = state.radiance + jnp.where(
        alive[:, None], thr_start * vol_emission, 0.0
    )

    # surface stage
    new_origin, new_dir, thr_mul, emission, continues, counts_depth = (
        _surface_interaction(scene, cfg, state, rec, u)
    )

    active = alive & rec.hit
    radiance = radiance + jnp.where(active[:, None], throughput * emission, 0.0)
    throughput = jnp.where(active[:, None], throughput * thr_mul, throughput)
    alive_next = active & continues & (jnp.max(throughput, axis=-1) > 0.0)
    origin = jnp.where(active[:, None], new_origin, state.origin)
    direction = jnp.where(active[:, None], new_dir, state.direction)
    depth = state.depth + jnp.where(active & counts_depth, 1, 0)

    # promotions run the math in f32; storage rounds back to the state's
    # spectral dtype (bf16 halves the dominant carry/intermediate traffic)
    sdt = state.throughput.dtype
    return RayState(
        origin=origin,
        direction=direction,
        throughput=throughput.astype(sdt),
        radiance=radiance.astype(sdt),
        alive=alive_next,
        depth=depth,
        segments=state.segments + jnp.sum(alive.astype(jnp.int32)),
        overflow=state.overflow,
    )


def _compact_lanes(st: RayState, divisor: int, lane_ids, radiance_full, key):
    """Sort lanes alive-first (random order within the alive block) and
    keep the top N/divisor.

    If more than N/divisor lanes are alive, a random subset survives and
    its throughput scales by alive/M — Russian-roulette reweighting, so
    compaction stays UNBIASED under overflow (extra variance instead of
    truncation bias).

    Returns (sub_state, kept lane ids, full-batch radiance array updated
    with the current lanes' radiance — dead lanes' values are final).
    """
    N = st.origin.shape[0]
    M = max(1, N // divisor)
    # cumsum PARTITION instead of a sort: two prefix sums + one scatter
    # are O(N), where a sort is O(N log N).
    # Under overflow the survivors are a random ROTATION of the alive
    # ranks: every alive lane's marginal keep probability is exactly M/A,
    # so the 1/p reweighting stays unbiased (rotation replaces the old iid
    # subset — same marginals, different lane correlations).
    alive = st.alive
    cnt = jnp.cumsum(alive.astype(jnp.int32))
    alive_count = cnt[-1]
    pos_alive = cnt - 1
    shift = jax.random.randint(key, (), 0, jnp.maximum(alive_count, 1))
    rank = (pos_alive + shift) % jnp.maximum(alive_count, 1)
    sel = alive & (rank < M)
    n_sel = jnp.sum(sel.astype(jnp.int32))
    dest = jnp.where(sel, rank,
                     n_sel + jnp.cumsum((~sel).astype(jnp.int32)) - 1)
    perm = jnp.zeros((N,), jnp.int32).at[dest].set(
        jnp.arange(N, dtype=jnp.int32))
    keep = perm[:M]
    overflow_scale = jnp.maximum(alive_count.astype(st.throughput.dtype) / M, 1.0)
    radiance_full = radiance_full.at[lane_ids].set(st.radiance)
    lane_ids = lane_ids[keep]
    alive_kept = st.alive[keep]
    thr_kept = (
        st.throughput[keep] * jnp.where(alive_kept, overflow_scale, 1.0)[:, None]
    ).astype(st.throughput.dtype)
    sub = RayState(
        origin=st.origin[keep],
        direction=st.direction[keep],
        throughput=thr_kept,
        radiance=st.radiance[keep],
        alive=alive_kept,
        depth=st.depth[keep],
        segments=st.segments,
        overflow=st.overflow + jnp.maximum(alive_count - M, 0),
    )
    return sub, lane_ids, radiance_full


def trace_rays(scene: CompiledScene, cfg: RayConfig, state: RayState, key):
    """Trace to termination with an early-exit while loop. Returns final state.

    ``cfg.compact_schedule`` applies the same staged stream compaction as
    the differentiable scan (see trace_rays_diff): between while-loop
    stages the batch sorts alive-first and shrinks, so the long tail of
    surviving paths no longer holds the full batch width hostage.
    """

    n_u = _n_uniforms(scene)

    def run_range(st, start, end):
        nsteps = end - start
        span_key = jax.random.fold_in(key, 0x7A000 + start)

        # hoist the whole span's RNG into one kernel (threefry re-entry per
        # bounce costs both compute and launches inside the serial loop)
        u_all = jax.random.uniform(
            span_key, (nsteps, st.origin.shape[0], n_u), st.origin.dtype,
        )

        if cfg.early_exit:
            def cond(carry):
                i, s = carry
                return (i < end) & jnp.any(s.alive)

            def body(carry):
                i, s = carry
                s = trace_step(scene, cfg, s, None, u=u_all[i - start])
                return i + 1, s

            _, final = jax.lax.while_loop(cond, body, (jnp.int32(start), st))
            return final

        def fbody(i, s):
            return trace_step(scene, cfg, s, None, u=u_all[i - start])

        return jax.lax.fori_loop(start, end, fbody, st)

    schedule = cfg.compact_schedule
    if not schedule:
        return run_range(state, 0, cfg.max_iters)

    N = state.origin.shape[0]
    done = 0
    st = state
    lane_ids = jnp.arange(N)
    radiance_full = jnp.zeros_like(state.radiance)
    for steps, divisor in schedule:
        steps = min(steps, cfg.max_iters - done)
        if steps <= 0:
            break
        st = run_range(st, done, done + steps)
        done += steps
        st, lane_ids, radiance_full = _compact_lanes(
            st, divisor, lane_ids, radiance_full,
            jax.random.fold_in(key, 1_000_000 + done),
        )
    if done < cfg.max_iters:
        st = run_range(st, done, cfg.max_iters)
    radiance_full = radiance_full.at[lane_ids].set(st.radiance)
    return RayState(
        origin=state.origin,
        direction=state.direction,
        throughput=state.throughput,
        radiance=radiance_full,
        alive=jnp.zeros(N, dtype=bool),
        depth=state.depth,
        segments=st.segments,
        overflow=st.overflow,
    )


def trace_rays_diff(scene: CompiledScene, cfg: RayConfig, state: RayState, key):
    """Fixed-iteration differentiable variant (lax.scan + remat per bounce).

    With ``cfg.compact_schedule`` set, the scan is split into stages with
    *stream compaction* between them: lanes are stably sorted alive-first
    and the batch is shrunk by the given divisor, so later bounces (where
    only a few percent of paths survive Russian roulette/escape) stop
    paying full-batch cost. Everything stays fixed-shape — the gather/
    scatter is differentiable and the radiance of compacted-away (dead)
    lanes is already final. If live lanes exceed a stage's capacity a
    random subset survives with 1/keep-prob reweighting (``_compact_lanes``)
    — Russian roulette, so compaction stays UNBIASED under overflow at the
    cost of extra variance; the per-trace ``overflow`` counter in the
    returned RayState reports how many lanes were reweighted so callers can
    loosen the divisors. Off by default — under a sharded batch axis the
    sort becomes a cross-device collective, so enable it for single-device
    rendering (bench) only.
    """

    n_u = _n_uniforms(scene)

    def _block(st, xs):
        """One checkpoint block of remat_block bounces: the carry is saved
        to HBM only at block boundaries; inner bounces recompute in the
        backward pass (cfg.remat_block rationale above). remat_block=0
        disables rematerialisation entirely — every bounce's primals are
        saved for the backward pass (more HBM, no recompute)."""

        def inner(s, ui):
            return trace_step(scene, cfg, s, None, u=ui), None

        st, _ = jax.lax.scan(inner, st, xs)
        return st, None

    block = _block if cfg.remat_block == 0 else jax.checkpoint(_block)

    def run_span(st, start, stop):
        """Scan [start, stop) bounces in remat blocks (remainder block last),
        with the span's RNG hoisted into one upfront kernel."""
        R = max(1, int(cfg.remat_block))
        n = stop - start
        span_key = jax.random.fold_in(key, 0x7A000 + start)
        u_all = jax.random.uniform(
            span_key, (n, st.origin.shape[0], n_u), st.origin.dtype,
        )
        full = n // R
        if full:
            st, _ = jax.lax.scan(
                block, st, u_all[: full * R].reshape(
                    full, R, st.origin.shape[0], n_u
                )
            )
        rem = n - full * R
        if rem:
            st, _ = block(st, u_all[full * R:])
        return st

    schedule = cfg.compact_schedule
    if not schedule:
        return run_span(state, 0, cfg.max_iters)

    N = state.origin.shape[0]
    done = 0
    st = state
    # index of each current lane in the ORIGINAL batch
    lane_ids = jnp.arange(N)
    radiance_full = jnp.zeros_like(state.radiance)
    for steps, divisor in schedule:
        steps = min(steps, cfg.max_iters - done)
        if steps <= 0:
            break
        st = run_span(st, done, done + steps)
        done += steps
        st, lane_ids, radiance_full = _compact_lanes(
            st, divisor, lane_ids, radiance_full,
            jax.random.fold_in(key, 1_000_000 + done),
        )
    if done < cfg.max_iters:
        st = run_span(st, done, cfg.max_iters)
    radiance_full = radiance_full.at[lane_ids].set(st.radiance)
    return RayState(
        origin=state.origin,
        direction=state.direction,
        throughput=state.throughput,
        radiance=radiance_full,
        alive=jnp.zeros(N, dtype=bool),
        depth=state.depth,
        segments=st.segments,
        overflow=st.overflow,
    )


def alive_profile(scene: CompiledScene, cfg: RayConfig, state: RayState, key):
    """Per-bounce alive-lane counts: i32[max_iters] telemetry for choosing a
    compaction schedule (one fixed-length scan, no radiance bookkeeping)."""

    def body(st, i):
        nxt = trace_step(scene, cfg, st, jax.random.fold_in(key, i))
        return nxt, jnp.sum(st.alive.astype(jnp.int32))

    _, counts = jax.lax.scan(body, state, jnp.arange(cfg.max_iters))
    return counts


def schedule_from_profile(counts, n_lanes, headroom=4, max_divisor=16,
                          min_stage_steps=2):
    """Derive a compact_schedule from measured per-bounce alive counts.

    Conservative by construction: a stage shrinks the CURRENT batch by 2x
    only once the measured alive fraction at that depth is below
    1/(headroom * cumulative_divisor) — with headroom 4x, overflow needs
    the later tiles to be 4x more alive than the measured tile. Returns a
    ((steps, divisor), ...) tuple (divisors are per-stage, relative)."""
    fracs = [c / max(1, n_lanes) for c in counts]
    schedule = []
    cum_div = 1
    steps_in_stage = 0
    for f in fracs:
        steps_in_stage += 1
        next_div = cum_div * 2
        if (
            steps_in_stage >= min_stage_steps
            and cum_div < max_divisor
            and f * headroom * next_div <= 1.0
        ):
            schedule.append((steps_in_stage, 2))
            cum_div = next_div
            steps_in_stage = 0
    return tuple(schedule)


def trace_rays_logged(scene: CompiledScene, cfg: RayConfig, state: RayState, key):
    """Path-logging variant (reference LoggingRay, optical/loggingray.pyx:45):
    a fixed-length scan that records, per bounce, the full intersection
    record for every ray — hit point, entity and material id, world normal,
    exiting flag, path throughput at the segment start and the segment
    length (the reference stores per-vertex Intersection objects,
    loggingray.pyx:45-202). Returns (final_state, log) where log is a dict
    of [max_iters, N, ...] arrays. Use ``reconstruct_trajectories`` to turn
    the SoA log into per-ray vertex lists on the host."""

    def body(st, i):
        rec = intersect_scene(scene, st.origin, st.direction)
        nxt = trace_step(scene, cfg, st, jax.random.fold_in(key, i))
        valid = st.alive & rec.hit
        mat_id = vmath.select_rows(
            scene.entity_material, jnp.maximum(rec.entity, 0)
        )
        entry = {
            "origin": st.origin,
            "hit_point": rec.point,
            "entity": jnp.where(valid, rec.entity, -1),
            "material": jnp.where(valid, mat_id, -1),
            "normal": rec.normal,
            "exiting": valid & rec.exiting,
            "throughput": st.throughput,
            "alive": st.alive,
            "t": jnp.where(rec.hit, rec.t, jnp.inf),
        }
        return nxt, entry

    final, log = jax.lax.scan(body, state, jnp.arange(cfg.max_iters))
    return final, log


def reconstruct_trajectories(log):
    """Host helper: turn a ``trace_rays_logged`` SoA log into per-ray
    trajectories (the reference's LoggingRay.path_vertices list of
    Intersection objects, loggingray.pyx:45-202).

    Returns a list of N trajectories; each is a list of per-vertex dicts
    with keys origin/hit_point/entity/material/normal/exiting/throughput/t,
    truncated at the first dead bounce."""
    import numpy as np

    alive = np.asarray(log["alive"])  # [D, N]
    D, N = alive.shape
    arrays = {k: np.asarray(v) for k, v in log.items()}
    out = []
    for n in range(N):
        path = []
        for i in range(D):
            if not alive[i, n]:
                break
            if not np.isfinite(arrays["t"][i, n]):
                break
            path.append({k: arrays[k][i, n] for k in arrays})
        out.append(path)
    return out
