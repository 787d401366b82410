"""source_tpu — a differentiable spectral ray-tracing framework on JAX.

A from-scratch re-design of the capabilities of raysect/source for
JAX/XLA on an accelerator: the scenegraph compiles to flat SoA device arrays,
path tracing runs as a wavefront megakernel, statistics fold with
psum-compatible Welford merges, and the whole forward pipeline is
differentiable w.r.t. geometry, material and emission parameters.

Top-level convenience exports mirror the reference's habit of importing
from ``raysect.core`` / ``raysect.optical`` / ``raysect.primitive``.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    AffineMatrix3D, Node, Normal3D, Point2D, Point3D, Quaternion, Vector2D,
    Vector3D, World, translate, rotate, rotate_basis, rotate_vector,
    rotate_x, rotate_y, rotate_z,
)
from .compiler import CompiledScene, SpectralConfig, compile_scene  # noqa: F401
from .tracer.wavefront import RayConfig, trace_rays, trace_rays_diff  # noqa: F401
from .tracer.intersect import intersect_scene  # noqa: F401
from .parallel import (  # noqa: F401
    MulticoreEngine, RenderEngine, SerialEngine, ShardedEngine,
)
from .accel import Accelerator, BoundPrimitive, KDTree, Unaccelerated  # noqa: F401

__all__ = [
    "AffineMatrix3D", "Node", "Normal3D", "Point2D", "Point3D", "Quaternion",
    "Vector2D", "Vector3D", "World", "translate", "rotate", "rotate_basis",
    "rotate_vector", "rotate_x", "rotate_y", "rotate_z",
    "CompiledScene", "SpectralConfig", "compile_scene",
    "RayConfig", "trace_rays", "trace_rays_diff", "intersect_scene",
    "RenderEngine", "SerialEngine", "MulticoreEngine", "ShardedEngine",
    "Accelerator", "BoundPrimitive", "KDTree", "Unaccelerated",
]
