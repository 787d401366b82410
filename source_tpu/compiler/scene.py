"""Scene compiler: scenegraph -> flat SoA device arrays.

This is the vectorised replacement for the reference's scenegraph
*interpreter* (World.hit walking a kd-tree of Python primitive objects,
core/scenegraph/world.pyx:125 + core/acceleration/kdtree.pyx). The
scenegraph is compiled once per (scene version, spectral slice) into:

  * a leaf table — every analytic solid in the scene (including CSG
    children), with world<->local transforms and a parameter block, grouped
    by primitive type so each type's batched kernel runs on a static slice;
  * an entity table — the traceable objects; simple entities map to one
    leaf, CSG entities carry a compiled boolean ``inside`` closure over
    their leaves (csg.pyx's interval logic re-expressed as bounded all-hits,
    SURVEY.md §7);
  * material tables — per-material-id type codes, static params, spectral
    curves baked onto the render's wavelength grid, and per-slice band
    averages (dielectric.pyx:176-177 semantics);
  * an importance table — emitter bounding spheres + sampling CDF
    (optical/scenegraph/world.pyx:88-129).

The jnp arrays form a pytree (differentiable scene parameters); structural
information (counts, type slices, programs) is static so the wavefront
kernel traces to fixed XLA control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.scenegraph.node import World
from ..optical.material.base import (
    MAT_CONTINUOUS_BSDF,
    MAT_DISCRETE_BSDF,
    NPARAMS,
    NSCALARS,
    NSLOTS,
    VOL_NONE,
)
from ..primitive import analytic as _a
from ..primitive.shapes import OP_INTERSECT, OP_LEAF, OP_SUBTRACT, OP_UNION

__all__ = ["CompiledScene", "compile_scene", "SpectralConfig"]

@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """One spectral slice of a render (base/slice.pyx:32)."""

    min_wavelength: float
    max_wavelength: float
    bins: int

    @property
    def delta_wavelength(self):
        return (self.max_wavelength - self.min_wavelength) / self.bins


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompiledScene:
    """Flat device-side scene (pytree: arrays are differentiable data)."""

    # leaves, grouped by type (type_slices static)
    leaf_w2l: Any  # f32[L,4,4]
    leaf_l2w: Any  # f32[L,4,4]
    leaf_params: Any  # f32[L,PARAM_BLOCK]
    # entities
    leaf_entity: Any  # i32[L] owning entity of each leaf
    entity_material: Any  # i32[E]
    # world->entity-local frame for EVERY entity (the primitive's own frame;
    # for a CSG solid this is the CSG node's transform, NOT any child leaf's
    # — reference optical/ray.pyx:441-453 hands each primitive its own
    # w2p/p2w to volume integration)
    entity_w2l: Any  # f32[E,4,4]
    # materials
    mat_params: Any  # f32[M,NPARAMS]
    mat_spectra: Any  # f32[M,NSLOTS,B]
    mat_scalars: Any  # f32[M,NSCALARS]
    # importance sampling (emitter bounding spheres)
    imp_centre: Any  # f32[I,3]
    imp_radius: Any  # f32[I]
    imp_weight: Any  # f32[I] normalised weights
    imp_cdf: Any  # f32[I]
    # spectral grid: bin-centre wavelengths (nm). TRACED data, so spectral
    # slices differing only in wavelength range share one compiled kernel
    # (the reference re-runs the render engine per slice,
    # base/observer.pyx:298-305; here slices reuse the same XLA program)
    wavelengths: Any = None  # f32[B]
    # triangle meshes (tuple of MeshTables pytrees, one per mesh entity)
    meshes: Any = ()

    # --- static structure (aux data) ---
    type_slices: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    n_leaves: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_entities: int = dataclasses.field(metadata=dict(static=True), default=0)
    simple_leaf_of_entity: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    csg_entities: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    mat_types: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    volume_entities: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    mesh_entities: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    mix_remaps: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    # (mat_idx, material object) rows for user ContinuousBSDF/DiscreteBSDF
    # subclasses — the objects are static scene structure; their methods are
    # traced into the wavefront dispatch (material.pyx:205-390 extension point)
    custom_materials: Tuple = dataclasses.field(metadata=dict(static=True), default=())
    has_roughen: bool = dataclasses.field(metadata=dict(static=True), default=False)
    has_importance: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # bin COUNT stays static (array shapes); the wavelength range is traced
    n_bins: int = dataclasses.field(metadata=dict(static=True), default=15)

    @property
    def bins(self):
        return self.n_bins


def _program_to_closure(program):
    """Compile a postfix CSG program into a python closure
    inside(leaf_contains: [..., L] bool) -> [...] bool.

    The program is static scene structure, so unrolling it in python traces
    to pure vector boolean ops — no lax.switch needed.
    """

    ops = tuple(program)

    def inside(leaf_contains):
        stack = []
        for op, operand in ops:
            if op == OP_LEAF:
                stack.append(leaf_contains[..., operand])
            elif op == OP_UNION:
                b = stack.pop()
                a = stack.pop()
                stack.append(a | b)
            elif op == OP_INTERSECT:
                b = stack.pop()
                a = stack.pop()
                stack.append(a & b)
            elif op == OP_SUBTRACT:
                b = stack.pop()
                a = stack.pop()
                stack.append(a & ~b)
            else:
                raise ValueError(f"Unknown CSG opcode {op}")
        if len(stack) != 1:
            raise ValueError("Malformed CSG program.")
        return stack[0]

    return inside


def compile_scene(world: World, spectral: SpectralConfig, dtype=jnp.float32) -> CompiledScene:
    """Flatten a World scenegraph into a CompiledScene for one spectral slice."""

    if not isinstance(world, World):
        raise TypeError("compile_scene expects a World root node.")

    # --- gather leaves + entities -------------------------------------------------
    leaf_records = []  # (type_id, l2w AffineMatrix3D, params)
    entities = []  # primitive objects
    programs = []  # postfix programs with global leaf indices
    leaf_entity = []

    mesh_prims = []  # (entity_id, Mesh primitive)

    for prim in world.primitives:
        entity_id = len(entities)
        if getattr(prim, "is_mesh", False):
            entities.append(prim)
            programs.append(None)
            mesh_prims.append((entity_id, prim))
            continue
        leaf_base = len(leaf_records)
        leaves = prim.csg_leaves(prim.to_root())
        program = prim.csg_program(leaf_base)
        entities.append(prim)
        programs.append(program)
        for leaf in leaves:
            leaf_records.append(leaf)
            leaf_entity.append(entity_id)

    n_leaves = len(leaf_records)
    n_entities = len(entities)
    if n_entities == 0:
        raise ValueError("Cannot compile an empty scene.")

    # sort leaves by type for static per-type kernel slices; keep a stable
    # permutation so programs can be re-indexed
    order = sorted(range(n_leaves), key=lambda i: (leaf_records[i][0], i))
    remap = {old: new for new, old in enumerate(order)}
    leaf_records = [leaf_records[i] for i in order]
    leaf_entity = [leaf_entity[i] for i in order]
    programs = [
        None if prog is None
        else [(op, remap[arg] if op == OP_LEAF else arg) for op, arg in prog]
        for prog in programs
    ]

    type_slices = []
    start = 0
    for t in sorted({r[0] for r in leaf_records}):
        count = sum(1 for r in leaf_records if r[0] == t)
        type_slices.append((t, start, start + count))
        start += count

    if n_leaves:
        l2w = np.stack([r[1].to_array(np.float64) for r in leaf_records])
        w2l = np.stack([r[1].inverse().to_array(np.float64) for r in leaf_records])
        params = np.stack([np.asarray(r[2], dtype=np.float64) for r in leaf_records])
    else:
        l2w = np.zeros((0, 4, 4))
        w2l = np.zeros((0, 4, 4))
        params = np.zeros((0, _a.PARAM_BLOCK))

    # classify simple vs csg vs mesh entities
    simple_leaf_of_entity = []
    csg_entities = []  # (entity_id, leaf_idx tuple, inside_closure)
    for e, prog in enumerate(programs):
        if prog is None:  # mesh entity
            simple_leaf_of_entity.append(-1)
        elif len(prog) == 1 and prog[0][0] == OP_LEAF:
            simple_leaf_of_entity.append(prog[0][1])
        else:
            simple_leaf_of_entity.append(-1)
            leaf_ids = tuple(arg for op, arg in prog if op == OP_LEAF)
            # re-express the program over local (gathered) leaf positions
            local = {g: i for i, g in enumerate(leaf_ids)}
            local_prog = tuple(
                (op, local[arg] if op == OP_LEAF else arg) for op, arg in prog
            )
            # store the hashable PROGRAM, not a closure: csg_entities is a
            # static jit field, and fresh closures hash by identity, which
            # forced a full recompile on every observe() pass
            csg_entities.append((e, leaf_ids, local_prog))

    # --- materials -----------------------------------------------------------------
    materials = []
    mat_index = {}
    entity_material = []

    def register_material(mat):
        key = id(mat)
        if key not in mat_index:
            mat_index[key] = len(materials)
            materials.append(mat)
            # children (Blend/Add mixes) compile into their own rows,
            # remapped per ray before dispatch; registration order keeps a
            # parent mix before its children so nested mixes resolve in one
            # ascending remap sweep
            for child in mat.child_materials():
                register_material(child)
        return mat_index[key]

    for prim in entities:
        mat = prim.material
        if mat is None:
            raise ValueError(
                f"Primitive {prim!r} has no material; every traceable primitive "
                "needs one (reference requires the same)."
            )
        entity_material.append(register_material(mat))

    M = len(materials)
    B = spectral.bins
    mat_types = tuple(m.MAT_TYPE for m in materials)
    mat_params = np.zeros((M, NPARAMS), dtype=np.float64)
    mat_spectra = np.zeros((M, NSLOTS, B), dtype=np.float64)
    mat_scalars = np.zeros((M, NSCALARS), dtype=np.float64)
    for i, m in enumerate(materials):
        mat_params[i] = m.compile_params()
        mat_spectra[i] = m.compile_spectra(
            spectral.min_wavelength, spectral.max_wavelength, B
        )
        mat_scalars[i] = m.compile_scalars(
            spectral.min_wavelength, spectral.max_wavelength
        )

    # mix remaps (Blend/Add modifiers): per-ray material-id reroll
    mix_remaps = []
    for i, m in enumerate(materials):
        if getattr(m, "IS_MIX", False):
            mix_remaps.append(
                (i, mat_index[id(m.m1)], mat_index[id(m.m2)], float(m.ADD_WEIGHT))
            )
    mix_remaps.sort()  # ascending ids -> nested mixes resolve in one sweep

    # user-extensible BSDFs: keep the material object as static structure so
    # its traceable sample/pdf/bsdf methods compile into the dispatch
    custom_materials = tuple(
        (i, m) for i, m in enumerate(materials)
        if m.MAT_TYPE in (MAT_CONTINUOUS_BSDF, MAT_DISCRETE_BSDF)
    )

    # volume-active entities (static unrolled loop in the tracer); the
    # inhomogeneous kind carries its material object (emission closure +
    # integrator) plus a STATIC trapezoid interval count derived from the
    # reference's step rule (emitter/inhomogeneous.pyx:135-139:
    # intervals = max(min_samples-1, floor(length/step))) evaluated at the
    # compile-time chord bound — the entity's bounding-sphere diameter.
    # max_samples caps the static unroll (jit needs a fixed count; the
    # reference's count is data-dependent).
    volume_entities = []
    mesh_slot_of_entity = {e: slot for slot, (e, _) in enumerate(mesh_prims)}
    import math as _math
    for e, prim in enumerate(entities):
        mat = materials[entity_material[e]]
        if mat.VOLUME_KIND != VOL_NONE:
            intervals = 1
            inner = mat
            while not hasattr(inner, "integrator") and hasattr(inner, "material"):
                inner = inner.material
            integ = getattr(inner, "integrator", None)
            if integ is not None:
                _, radius = prim.bounding_sphere()
                intervals = int(min(
                    max(integ.min_samples - 1,
                        _math.ceil(2.0 * float(radius) / integ.step)),
                    max(integ.max_samples - 1, integ.min_samples - 1),
                ))
            volume_entities.append((
                e, entity_material[e], mat.VOLUME_KIND, mat,
                simple_leaf_of_entity[e], mesh_slot_of_entity.get(e, -1),
                intervals,
            ))

    # --- meshes (shared MeshData -> per-instance MeshTables) -----------------------
    mesh_tables = []
    mesh_entities = []
    for slot, (e, prim) in enumerate(mesh_prims):
        m = prim.to_root()
        l2w_m = m.to_array(np.float64)
        w2l_m = m.inverse().to_array(np.float64)
        mesh_tables.append(prim.data.to_tables(w2l_m, l2w_m))
        mesh_entities.append((e, slot))

    # --- importance manager (optical/scenegraph/world.pyx:88-129) ------------------
    imp_centre = []
    imp_radius = []
    imp_weight = []
    for e, prim in enumerate(entities):
        mat = materials[entity_material[e]]
        if mat.importance > 0.0:
            centre, radius = prim.bounding_sphere()
            imp_centre.append([centre.x, centre.y, centre.z])
            imp_radius.append(radius)
            imp_weight.append(mat.importance)
    has_importance = len(imp_centre) > 0
    if has_importance:
        imp_centre = np.asarray(imp_centre, dtype=np.float64)
        imp_radius = np.asarray(imp_radius, dtype=np.float64)
        w = np.asarray(imp_weight, dtype=np.float64)
        w = w / w.sum()
        imp_cdf = np.cumsum(w)
    else:
        imp_centre = np.zeros((1, 3))
        imp_radius = np.ones(1)
        w = np.ones(1)
        imp_cdf = np.ones(1)

    return CompiledScene(
        leaf_w2l=jnp.asarray(w2l, dtype),
        leaf_l2w=jnp.asarray(l2w, dtype),
        leaf_params=jnp.asarray(params, dtype),
        leaf_entity=jnp.asarray(leaf_entity, jnp.int32),
        entity_material=jnp.asarray(entity_material, jnp.int32),
        entity_w2l=jnp.asarray(
            np.stack([
                p.to_root().inverse().to_array(np.float64) for p in entities
            ]),
            dtype,
        ),
        mat_params=jnp.asarray(mat_params, dtype),
        mat_spectra=jnp.asarray(mat_spectra, dtype),
        mat_scalars=jnp.asarray(mat_scalars, dtype),
        imp_centre=jnp.asarray(imp_centre, dtype),
        imp_radius=jnp.asarray(imp_radius, dtype),
        imp_weight=jnp.asarray(w, dtype),
        imp_cdf=jnp.asarray(imp_cdf, dtype),
        wavelengths=jnp.asarray(
            spectral.min_wavelength
            + (np.arange(B) + 0.5) * spectral.delta_wavelength,
            dtype,
        ),
        meshes=tuple(mesh_tables),
        type_slices=tuple(type_slices),
        n_leaves=n_leaves,
        n_entities=n_entities,
        simple_leaf_of_entity=tuple(simple_leaf_of_entity),
        csg_entities=tuple(csg_entities),
        mat_types=mat_types,
        volume_entities=tuple(volume_entities),
        mesh_entities=tuple(mesh_entities),
        mix_remaps=tuple(mix_remaps),
        custom_materials=custom_materials,
        has_roughen=bool(
            any(m.compile_params()[7] > 0.0 for m in materials)
        ),
        has_importance=has_importance,
        n_bins=B,
    )
