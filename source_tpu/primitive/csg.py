"""Constructive solid geometry primitives.

Vectorised re-design of raysect/primitive/csg.pyx (CSGPrimitive:42,
Union:330, Intersect:387, Subtract:491). The reference resolves CSG by
lazily enumerating child intersections through ``next_intersection`` cursors;
here that becomes a *bounded all-hits* formulation (SURVEY.md §7): every
analytic leaf reports all boundary crossings up front, and the wavefront
intersector finds the first crossing where the boolean inside-state of the
compiled postfix program flips. Host-side, these classes just build that
program over their children's leaves.

Children are held in a private (un-rooted) subtree, mirroring the
reference's hidden CSGRoot scenegraph (csg.pyx:265-290): they never register
with the World and their transforms compose through the CSG node.
"""

from __future__ import annotations

import numpy as np

from ..core.scenegraph.node import Primitive
from .shapes import OP_INTERSECT, OP_LEAF, OP_SUBTRACT, OP_UNION

__all__ = ["CSGPrimitive", "Union", "Intersect", "Subtract"]


class CSGPrimitive(Primitive):
    """Base for CSG boolean operators (csg.pyx:42)."""

    _op = None

    def __init__(self, primitive_a=None, primitive_b=None, parent=None,
                 transform=None, material=None, name=None):
        from .shapes import Box
        from ..core.math.vector import Point3D

        primitive_a = primitive_a if primitive_a is not None else Box()
        primitive_b = primitive_b if primitive_b is not None else Box()
        for p in (primitive_a, primitive_b):
            if p.parent is not None:
                raise ValueError(
                    "A CSG child primitive cannot already be attached to a scenegraph."
                )
        self._primitive_a = primitive_a
        self._primitive_b = primitive_b
        super().__init__(parent, transform, material, name)

    @property
    def primitive_a(self):
        return self._primitive_a

    @property
    def primitive_b(self):
        return self._primitive_b

    def csg_leaves(self, world_transform):
        leaves = []
        for child in (self._primitive_a, self._primitive_b):
            child_world = world_transform * child.transform
            leaves.extend(child.csg_leaves(child_world))
        return leaves

    def n_csg_leaves(self):
        return self._primitive_a.n_csg_leaves() + self._primitive_b.n_csg_leaves()

    def csg_program(self, leaf_base):
        prog_a = self._primitive_a.csg_program(leaf_base)
        prog_b = self._primitive_b.csg_program(
            leaf_base + self._primitive_a.n_csg_leaves()
        )
        return prog_a + prog_b + [(self._op, 0)]

    def bounding_box_world(self, world_transform):
        lo_a, hi_a = self._primitive_a.bounding_box_world(
            world_transform * self._primitive_a.transform
        )
        lo_b, hi_b = self._primitive_b.bounding_box_world(
            world_transform * self._primitive_b.transform
        )
        return self._combine_aabb(lo_a, hi_a, lo_b, hi_b)

    def bounding_box(self):
        return self.bounding_box_world(self.to_root())

    def _combine_aabb(self, lo_a, hi_a, lo_b, hi_b):
        raise NotImplementedError

    def instance(self, parent=None, transform=None, material=None, name=None):
        obj = type(self).__new__(type(self))
        Primitive.__init__(obj, parent, transform, material or self.material, name)
        obj._primitive_a = self._primitive_a
        obj._primitive_b = self._primitive_b
        return obj


class Union(CSGPrimitive):
    """Boolean union A | B (csg.pyx:330)."""

    _op = OP_UNION

    def _combine_aabb(self, lo_a, hi_a, lo_b, hi_b):
        return np.minimum(lo_a, lo_b), np.maximum(hi_a, hi_b)


class Intersect(CSGPrimitive):
    """Boolean intersection A & B (csg.pyx:387)."""

    _op = OP_INTERSECT

    def _combine_aabb(self, lo_a, hi_a, lo_b, hi_b):
        return np.maximum(lo_a, lo_b), np.minimum(hi_a, hi_b)


class Subtract(CSGPrimitive):
    """Boolean difference A - B (csg.pyx:491)."""

    _op = OP_SUBTRACT

    def _combine_aabb(self, lo_a, hi_a, lo_b, hi_b):
        return lo_a, hi_a
