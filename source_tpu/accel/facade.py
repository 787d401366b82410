"""Accelerator facade (reference core/acceleration/*.pyx).

The reference exposes a pluggable host-side accelerator: ``Accelerator``
(accelerator.pyx:32-40, build/hit/contains), ``BoundPrimitive``
(boundprimitive.pyx:34, primitive + world-space AABB pre-test), ``KDTree``
(kdtree.pyx:165-180) and ``Unaccelerated`` (unaccelerated.pyx:41-105).

Design: the real accelerator here is scene *compilation* — analytic
leaves are intersected in grouped batches, meshes traverse a threaded BVH
or, when small, an all-pairs test (SURVEY.md §2.4, PARITY.md). These classes keep the
reference's interactive host-query contract: ``build`` compiles (or
recompiles) the scene tables, ``hit``/``contains`` run the batched device
query for a single ray/point. ``KDTree`` and ``Unaccelerated`` therefore
share one code path whose asymptotics already match or beat both.
"""

from __future__ import annotations

__all__ = ["Accelerator", "BoundPrimitive", "KDTree", "Unaccelerated"]


class Accelerator:
    """Abstract accelerator contract (accelerator.pyx:32-40)."""

    def build(self, world, force=False):
        """Prepare the acceleration structure for ``world``'s primitives."""
        raise NotImplementedError

    def hit(self, ray):
        """Closest Intersection of ``ray`` with the built scene, or None."""
        raise NotImplementedError

    def contains(self, point):
        """List of primitives containing ``point``."""
        raise NotImplementedError


class BoundPrimitive:
    """A primitive paired with its world-space AABB (boundprimitive.pyx:34).

    The box is the cheap pre-test: ``box_hit(ray)`` runs the slab test
    before any primitive-level query is attempted.
    """

    def __init__(self, primitive):
        from ..core.boundingbox import BoundingBox3D
        from ..core.math.vector import Point3D

        self.primitive = primitive
        lower, upper = primitive.bounding_box()
        self.box = BoundingBox3D(Point3D(*lower), Point3D(*upper))

    def box_hit(self, ray):
        """Slab test of ``ray`` against the primitive's world AABB."""
        hit, _, _ = self.box.hit(ray.origin, ray.direction)
        return hit

    def contains(self, point):
        return self.box.contains(point)


class _CompiledSceneAccelerator(Accelerator):
    """Shared implementation: the scene-compile IS the build step."""

    def __init__(self):
        self._world = None

    def build(self, world, force=False):
        self._world = world
        world.build_accelerator(force=force)
        self.bound_primitives = [BoundPrimitive(p) for p in world.primitives]

    def hit(self, ray):
        if self._world is None:
            raise RuntimeError("Accelerator not built: call build(world).")
        return self._world.hit(ray)

    def contains(self, point):
        if self._world is None:
            raise RuntimeError("Accelerator not built: call build(world).")
        return self._world.contains(point)


class KDTree(_CompiledSceneAccelerator):
    """Default accelerator name kept from the reference (kdtree.pyx:165).

    Here the per-query tree walk is replaced by batched leaf
    intersection + BVH traversal over the compiled tables."""


class Unaccelerated(_CompiledSceneAccelerator):
    """Reference/debug linear-scan accelerator (unaccelerated.pyx:41).

    Kept as a distinct type for API parity; the compiled-scene query is
    already the batched equivalent of the linear scan."""
