"""Non-imaging observers: Pixel, SightLine, FibreOptic, TargetedPixel,
MeshPixel, MeshCamera.

Counterparts of raysect/optical/observer/nonimaging/{pixel,
sightline,fibreoptic,targeted_pixel,mesh_pixel,mesh_camera}.pyx. Each
observer is a batched device ray generator over the shared Observer0D/1D
machinery; etendue factors are carried as per-pixel sensitivities exactly
as the reference does.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ...core.math import batch as vmath
from ...core.math import random as vrand
from .base import Observer0D, Observer1D
from .pipelines import PowerPipeline0D

__all__ = [
    "Pixel", "SightLine", "FibreOptic", "TargetedPixel",
    "MeshPixel", "MeshCamera",
]

_PI = math.pi


def _default_pipelines(p):
    return p if p is not None else [PowerPipeline0D()]


class Pixel(Observer0D):
    """Rectangular collecting surface with cosine-hemisphere acceptance
    (nonimaging/pixel.pyx:41,152). Sensitivity = area * pi (etendue of a
    cosine-weighted hemisphere over the pixel area)."""

    _rays_per_sample = 4

    def __init__(self, x_width=0.01, y_width=0.01, pipelines=None, parent=None,
                 transform=None, name=None):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name)
        if x_width <= 0 or y_width <= 0:
            raise ValueError("Pixel dimensions must be greater than zero.")
        self.x_width = float(x_width)
        self.y_width = float(y_width)

    @property
    def etendue(self):
        return self.x_width * self.y_width * _PI

    @property
    def collection_area(self):
        return self.x_width * self.y_width

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        origin = jnp.stack(
            [
                (u[..., 0] - 0.5) * self.x_width,
                (u[..., 1] - 0.5) * self.y_width,
                jnp.zeros_like(u[..., 0]),
            ],
            axis=-1,
        )
        direction = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        weight = jnp.ones_like(u[..., 0])
        return origin, direction, weight


class SightLine(Observer0D):
    """Single line of sight along +z (nonimaging/sightline.pyx:39):
    measures radiance directly."""

    _rays_per_sample = 2

    def __init__(self, sensitivity=1.0, pipelines=None, parent=None,
                 transform=None, name=None):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name)
        if sensitivity <= 0:
            raise ValueError("Sensitivity must be greater than zero.")
        self.sensitivity = float(sensitivity)

    def _pixel_sensitivity_array(self):
        return np.asarray([self.sensitivity], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        z = jnp.zeros_like(u[..., 0])
        origin = jnp.stack([z, z, z], axis=-1)
        direction = jnp.stack([z, z, jnp.ones_like(z)], axis=-1)
        return origin, direction, jnp.ones_like(z)


class FibreOptic(Observer0D):
    """Optical fibre: circular core with a cone acceptance
    (nonimaging/fibreoptic.pyx:48). Uniform-cone direction samples carry a
    cos(theta) weight; sensitivity = core area * cone solid angle."""

    _rays_per_sample = 4

    def __init__(self, acceptance_angle=5.0, radius=0.001, pipelines=None,
                 parent=None, transform=None, name=None):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name)
        if not 0 < acceptance_angle <= 90:
            raise ValueError("Acceptance angle must lie in (0, 90] degrees.")
        if radius <= 0:
            raise ValueError("Fibre radius must be greater than zero.")
        self.acceptance_angle = float(acceptance_angle)
        self.radius = float(radius)
        self._cos_max = math.cos(math.radians(acceptance_angle))

    @property
    def solid_angle(self):
        return 2.0 * _PI * (1.0 - self._cos_max)

    @property
    def collection_area(self):
        return _PI * self.radius * self.radius

    @property
    def etendue(self):
        return self.collection_area * self.solid_angle

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        origin = vrand.point_disk(u[..., 0], u[..., 1], self.radius)
        direction = vrand.vector_cone_uniform(u[..., 2], u[..., 3], self._cos_max)
        weight = direction[..., 2]  # cos(theta) radiometric factor
        return origin, direction, weight


class TargetedPixel(Observer0D):
    """Pixel with targeted direction sampling toward a primitive's bounding
    sphere (nonimaging/targeted_pixel.pyx:45): with probability
    ``targeted_path_prob`` a uniform-cone sample toward the target, else a
    cosine-hemisphere sample, both weighted by the mixture pdf (one-sample
    MIS, matching ContinuousBSDF weighting)."""

    _rays_per_sample = 6

    def __init__(self, target, x_width=0.01, y_width=0.01,
                 targeted_path_prob=0.9, pipelines=None, parent=None,
                 transform=None, name=None):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name)
        if x_width <= 0 or y_width <= 0:
            raise ValueError("Pixel dimensions must be greater than zero.")
        if not 0 < targeted_path_prob <= 1:
            raise ValueError("targeted_path_prob must lie in (0, 1].")
        self.target = target
        self.x_width = float(x_width)
        self.y_width = float(y_width)
        self.targeted_path_prob = float(targeted_path_prob)

    @property
    def etendue(self):
        return self.x_width * self.y_width * _PI

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _target_sphere_local(self):
        """Target bounding sphere in this observer's local frame."""
        centre, radius = self.target.bounding_sphere()
        c_local = centre.transform(self.to_local())
        return (c_local.x, c_local.y, c_local.z, radius)

    def _kernel_cache_extra(self):
        return self._target_sphere_local()

    def _generate_rays_device(self, px, py, u):
        cx, cy, cz, radius = self._target_sphere_local()
        origin = jnp.stack(
            [
                (u[..., 0] - 0.5) * self.x_width,
                (u[..., 1] - 0.5) * self.y_width,
                jnp.zeros_like(u[..., 0]),
            ],
            axis=-1,
        )
        centre = jnp.asarray([cx, cy, cz], origin.dtype)
        to_c = centre[None, None, :] - origin
        dist = jnp.sqrt(jnp.sum(to_c * to_c, axis=-1) + 1e-30)
        axis = to_c / dist[..., None]
        sin2 = jnp.clip((radius / dist) ** 2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.clip(1.0 - sin2, 0.0, 1.0))
        cos_max = jnp.where(dist <= radius, -1.0, cos_max)

        # candidate directions
        local_cone = vrand.vector_cone_uniform(u[..., 2], u[..., 3], cos_max)
        t_f, b_f, n_f = vmath.make_frame(axis)
        d_cone = vmath.from_frame(local_cone, t_f, b_f, n_f)
        d_cos = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        p = self.targeted_path_prob
        pick_cone = u[..., 4] < p
        direction = jnp.where(pick_cone[..., None], d_cone, d_cos)

        # mixture pdf at the chosen direction
        cos_theta = jnp.clip(direction[..., 2], 0.0, 1.0)
        pdf_cos = cos_theta / _PI
        cos_to_axis = jnp.sum(direction * axis, axis=-1)
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        pdf_cone = jnp.where(
            cos_to_axis >= cos_max, 1.0 / jnp.maximum(solid_angle, 1e-12), 0.0
        )
        pdf = p * pdf_cone + (1.0 - p) * pdf_cos
        ok = (pdf > 1e-12) & (direction[..., 2] > 0.0)
        # estimator weight: (cos/pi) / pdf restores the cosine-hemisphere
        # measure the etendue sensitivity assumes
        weight = jnp.where(ok, pdf_cos / jnp.maximum(pdf, 1e-12), 0.0)
        return origin, direction, weight


class _MeshSurfaceSampler:
    """Area-weighted triangle sampling over a MeshData (host tables)."""

    def __init__(self, mesh_data):
        d = mesh_data
        v0 = d.vertices[d.triangles[:, 0]]
        v1 = d.vertices[d.triangles[:, 1]]
        v2 = d.vertices[d.triangles[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        self.total_area = float(areas.sum())
        cdf = np.cumsum(areas)
        self.cdf = jnp.asarray((cdf / cdf[-1]).astype(np.float32))
        self.areas = areas
        self.v0 = jnp.asarray(v0)
        self.v1 = jnp.asarray(v1)
        self.v2 = jnp.asarray(v2)
        self.normals = jnp.asarray(d.face_normals)


class MeshPixel(Observer0D):
    """Observe from a mesh surface (nonimaging/mesh_pixel.pyx:61): points
    area-uniform over all triangles, cosine-hemisphere directions about the
    face normal. Sensitivity = total area * pi."""

    _rays_per_sample = 5

    def __init__(self, mesh_data, surface_offset=1e-6, pipelines=None,
                 parent=None, transform=None, name=None):
        super().__init__(pipelines=_default_pipelines(pipelines), parent=parent,
                         transform=transform, name=name)
        self._sampler = _MeshSurfaceSampler(mesh_data)
        self.surface_offset = float(surface_offset)

    @property
    def collection_area(self):
        return self._sampler.total_area

    @property
    def etendue(self):
        return self._sampler.total_area * _PI

    def _pixel_sensitivity_array(self):
        return np.asarray([self.etendue], dtype=np.float32)

    def _generate_rays_device(self, px, py, u):
        tri_u = u[..., 0]
        sampler = self._sampler
        tri = jnp.clip(
            jnp.searchsorted(sampler.cdf, tri_u, side="left"),
            0, sampler.cdf.shape[0] - 1,
        )
        p = vrand.point_triangle(
            u[..., 1], u[..., 2], sampler.v0[tri], sampler.v1[tri], sampler.v2[tri]
        )
        n = sampler.normals[tri]
        t_f, b_f, n_f = vmath.make_frame(n)
        d_local = vrand.vector_hemisphere_cosine(u[..., 3], u[..., 4])
        direction = vmath.from_frame(d_local, t_f, b_f, n_f)
        origin = p + n * self.surface_offset
        weight = jnp.ones_like(tri_u)
        return origin, direction, weight


class MeshCamera(Observer1D):
    """Per-triangle observer (nonimaging/mesh_camera.pyx:61): pixel i
    collects from triangle i of the mesh (area-etendue sensitivity per
    triangle)."""

    _rays_per_sample = 4

    def __init__(self, mesh_data, surface_offset=1e-6, pipelines=None,
                 frame_sampler=None, parent=None, transform=None, name=None):
        sampler = _MeshSurfaceSampler(mesh_data)
        super().__init__(
            pixels=int(sampler.areas.shape[0]), frame_sampler=frame_sampler,
            pipelines=_default_pipelines(pipelines), parent=parent,
            transform=transform, name=name,
        )
        self._sampler = sampler
        self.surface_offset = float(surface_offset)

    def _pixel_sensitivity_array(self):
        return (self._sampler.areas * _PI).astype(np.float32)

    def _generate_rays_device(self, px, py, u):
        sampler = self._sampler
        tri = jnp.clip(px, 0, sampler.cdf.shape[0] - 1)
        tri = jnp.broadcast_to(tri, u[..., 0].shape)
        p = vrand.point_triangle(
            u[..., 0], u[..., 1], sampler.v0[tri], sampler.v1[tri], sampler.v2[tri]
        )
        n = sampler.normals[tri]
        t_f, b_f, n_f = vmath.make_frame(n)
        d_local = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        direction = vmath.from_frame(d_local, t_f, b_f, n_f)
        origin = p + n * self.surface_offset
        weight = jnp.ones_like(u[..., 0])
        return origin, direction, weight
