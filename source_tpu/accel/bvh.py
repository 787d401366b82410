"""Host-side BVH build with a native (C++) SAH builder.

Replacement for the reference's generic spatial kd-tree
(raysect/core/math/spatial/kdtree3d.pyx:103-393): geometry acceleration is
built on the host in native code and shipped to the device as flat arrays.
The layout is *threaded* depth-first order — every node stores its escape
index — so traversal is stackless (see tracer/meshtrace.py), which is the
shape a lax.while_loop wavefront kernel needs.

The native builder (csrc/bvh.cpp) is compiled on demand with g++ into a
shared library inside the checkout (``source_tpu.runtime.build_native``); a
pure-numpy median-split builder with the identical output format is the
fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import threading

import numpy as np

from ..runtime import build_native

__all__ = ["FlatBVH", "build_bvh", "native_builder_available"]

_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


@dataclasses.dataclass
class FlatBVH:
    """Threaded flat BVH (DFS order with escape indices).

    node_lo/node_hi: f32[NN,3] AABBs
    node_skip:       i32[NN] escape index (node + subtree size)
    node_first:      i32[NN] first primitive of a leaf (-1 for inner nodes)
    node_count:      i32[NN] leaf primitive count (0 for inner nodes)
    order:           i32[T] primitive permutation; leaves are contiguous
                     (first, count) ranges of the permuted primitive array
    """

    node_lo: np.ndarray
    node_hi: np.ndarray
    node_skip: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    order: np.ndarray

    @property
    def n_nodes(self):
        return int(self.node_skip.shape[0])

    @property
    def max_leaf_size(self):
        return int(self.node_count.max())


def _load_native():
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            lib_path = build_native("bvh")
            if lib_path is None:
                _LIB_FAILED = True
                return None
            lib = ctypes.CDLL(lib_path)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.bvh_build.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                f32p, f32p, i32p, i32p, i32p, i32p,
            ]
            lib.bvh_build.restype = ctypes.c_int
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB_FAILED = True
            _LIB = None
        return _LIB


def native_builder_available():
    """True when the native SAH builder loads; False means ``build_bvh``
    takes the numpy median-split fallback."""
    return _load_native() is not None


def _build_numpy(tri_lo, tri_hi, max_leaf):
    """Median-split fallback with the identical threaded output format.

    Traversal uses an explicit ``Stack`` (core/containers.py) instead of
    Python recursion: a degenerate input (all centroids coincident) makes
    the median split depth O(T/max_leaf), which would overflow the
    interpreter's recursion limit long before it exhausts memory.
    """
    from ..core.containers import Stack

    n = tri_lo.shape[0]
    cent = 0.5 * (tri_lo + tri_hi)
    order = np.arange(n, dtype=np.int32)
    node_lo, node_hi, node_skip, node_first, node_count = [], [], [], [], []

    # ("enter", first, count) emits a node and schedules its children;
    # ("exit", idx) threads the skip pointer once the subtree is complete.
    stack = Stack()
    stack.push(("enter", 0, n))
    while not stack.is_empty():
        item = stack.pop()
        if item[0] == "exit":
            node_skip[item[1]] = len(node_lo)
            continue
        _, first, count = item
        idx = len(node_lo)
        ids = order[first:first + count]
        node_lo.append(tri_lo[ids].min(axis=0))
        node_hi.append(tri_hi[ids].max(axis=0))
        node_skip.append(0)
        stack.push(("exit", idx))
        if count <= max_leaf:
            node_first.append(first)
            node_count.append(count)
        else:
            node_first.append(-1)
            node_count.append(0)
            axis = int(np.argmax(cent[ids].max(0) - cent[ids].min(0)))
            key = np.argsort(cent[ids, axis], kind="stable")
            order[first:first + count] = ids[key]
            mid = count // 2
            # LIFO: push right before left so the left subtree emits first
            # (preserves the recursive preorder node layout exactly)
            stack.push(("enter", first + mid, count - mid))
            stack.push(("enter", first, mid))
    return FlatBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_skip=np.asarray(node_skip, np.int32),
        node_first=np.asarray(node_first, np.int32),
        node_count=np.asarray(node_count, np.int32),
        order=order,
    )


def build_bvh(tri_lo, tri_hi, max_leaf=4, traversal_cost=1.0):
    """Build a threaded flat BVH over primitive AABBs.

    tri_lo/tri_hi: f32[T,3] per-primitive AABB corners.
    """
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    n = tri_lo.shape[0]
    lib = _load_native()
    if lib is None:
        return _build_numpy(tri_lo, tri_hi, max_leaf)
    cap = 2 * n
    out_lo = np.empty((cap, 3), np.float32)
    out_hi = np.empty((cap, 3), np.float32)
    out_skip = np.empty(cap, np.int32)
    out_first = np.empty(cap, np.int32)
    out_count = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int32)
    nn = lib.bvh_build(
        tri_lo, tri_hi, n, int(max_leaf), float(traversal_cost),
        out_lo, out_hi, out_skip, out_first, out_count, out_order,
    )
    if nn < 0:
        return _build_numpy(tri_lo, tri_hi, max_leaf)
    return FlatBVH(
        node_lo=out_lo[:nn].copy(),
        node_hi=out_hi[:nn].copy(),
        node_skip=out_skip[:nn].copy(),
        node_first=out_first[:nn].copy(),
        node_count=out_count[:nn].copy(),
        order=out_order,
    )
