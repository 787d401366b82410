"""Imaging observers (cameras).

Counterparts of raysect/optical/observer/imaging/{pinhole,
orthographic,ccd,vector,opencv,targeted_ccd}.pyx. Each camera supplies a
batched device ray generator; everything else (spectral slicing, tiling,
tracing, statistics) lives in Observer2D.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ...core.math import random as vrand
from .base import Observer2D
from .cameras import orthographic_rays, pinhole_geometry, pinhole_rays
from .pipelines import RGBPipeline2D

__all__ = [
    "PinholeCamera",
    "OrthographicCamera",
    "CCDArray",
    "VectorCamera",
    "OpenCVCamera",
    "TargetedCCDArray",
]


class PinholeCamera(Observer2D):
    """Ideal pinhole camera (imaging/pinhole.pyx:42).

    fov is the angle across the horizontal field of view in degrees.
    """

    _rays_per_sample = 2

    def __init__(self, pixels=(512, 512), fov=45.0, sensitivity=1.0,
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None, render_engine=None):
        pipelines = pipelines if pipelines is not None else [RGBPipeline2D()]
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=pipelines,
            parent=parent, transform=transform, name=name,
            render_engine=render_engine,
        )
        self._fov = None
        self._sensitivity = None
        self.fov = fov
        self.sensitivity = sensitivity

    @property
    def fov(self):
        return self._fov

    @fov.setter
    def fov(self, value):
        if value <= 0 or value >= 180:
            raise ValueError("The field-of-view angle must lie in the range (0, 180).")
        self._fov = float(value)

    @property
    def sensitivity(self):
        return self._sensitivity

    @sensitivity.setter
    def sensitivity(self, value):
        if value <= 0:
            raise ValueError("Sensitivity must be greater than zero.")
        self._sensitivity = float(value)

    def _pixel_sensitivity_array(self):
        return np.full(self.pixels[0] * self.pixels[1], self._sensitivity, np.float32)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        return pinhole_rays(px, py, u[..., 0], u[..., 1], nx, ny, self._fov)


class OrthographicCamera(Observer2D):
    """Parallel projection camera (imaging/orthographic.pyx:41)."""

    _rays_per_sample = 2

    def __init__(self, pixels=(512, 512), width=1.0, sensitivity=1.0,
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None, render_engine=None):
        pipelines = pipelines if pipelines is not None else [RGBPipeline2D()]
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=pipelines,
            parent=parent, transform=transform, name=name,
            render_engine=render_engine,
        )
        self._width = None
        self.width = width
        self.sensitivity = float(sensitivity)

    @property
    def width(self):
        return self._width

    @width.setter
    def width(self, value):
        if value <= 0:
            raise ValueError("Width must be greater than zero.")
        self._width = float(value)

    def _pixel_sensitivity_array(self):
        return np.full(self.pixels[0] * self.pixels[1], self.sensitivity, np.float32)

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        return orthographic_rays(px, py, u[..., 0], u[..., 1], nx, ny, self._width)


class CCDArray(Observer2D):
    """Physically-modelled CCD sensor array (imaging/ccd.pyx:42).

    Pixels observe a cosine-weighted hemisphere; the etendue-correct pixel
    sensitivity pi * A_pixel is applied so PowerPipelines read W.
    """

    _rays_per_sample = 4

    def __init__(self, pixels=(720, 480), width=0.035, frame_sampler=None,
                 pipelines=None, parent=None, transform=None, name=None,
                 render_engine=None):
        pipelines = pipelines if pipelines is not None else [RGBPipeline2D()]
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=pipelines,
            parent=parent, transform=transform, name=name,
            render_engine=render_engine,
        )
        self._width = None
        self.width = width

    @property
    def width(self):
        return self._width

    @width.setter
    def width(self, value):
        if value <= 0:
            raise ValueError("Width must be greater than zero.")
        self._width = float(value)
        self._update_geometry()

    def _update_geometry(self):
        nx, ny = self.pixels
        self._pixel_area = (self._width / nx) ** 2

    def _pixel_sensitivity_array(self):
        # etendue: pi * A (cosine-weighted hemisphere integral of cos)
        return np.full(
            self.pixels[0] * self.pixels[1],
            math.pi * self._pixel_area,
            np.float32,
        )

    def _generate_rays_device(self, px, py, u):
        nx, ny = self.pixels
        delta = self._width / nx
        sx = 0.5 * nx * delta
        sy = 0.5 * ny * delta
        dtype = jnp.float32
        ox = sx - delta * (px.astype(dtype) + 0.5) + (u[..., 0] - 0.5) * delta
        oy = sy - delta * (py.astype(dtype) + 0.5) + (u[..., 1] - 0.5) * delta
        origin = jnp.stack([ox, oy, jnp.zeros_like(ox)], axis=-1)
        direction = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        weight = jnp.ones_like(ox)
        return origin, direction, weight


class VectorCamera(Observer2D):
    """Calibrated per-pixel ray camera (imaging/vector.pyx:44)."""

    _rays_per_sample = 2

    def __init__(self, pixel_origins, pixel_directions, frame_sampler=None,
                 pipelines=None, parent=None, transform=None, name=None):
        pixel_origins = np.asarray(pixel_origins, np.float32)
        pixel_directions = np.asarray(pixel_directions, np.float32)
        if pixel_origins.ndim == 2 and pixel_origins.dtype == object:
            raise ValueError("pixel_origins must be a numeric array [nx, ny, 3].")
        if pixel_origins.shape != pixel_directions.shape or pixel_origins.shape[-1] != 3:
            raise ValueError("Origin and direction arrays must both be [nx, ny, 3].")
        pixels = pixel_origins.shape[:2]
        pipelines = pipelines if pipelines is not None else [RGBPipeline2D()]
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=pipelines,
            parent=parent, transform=transform, name=name,
        )
        self.pixel_origins = jnp.asarray(pixel_origins)
        self.pixel_directions = jnp.asarray(pixel_directions)

    def _generate_rays_device(self, px, py, u):
        # broadcast the per-pixel calibrated rays over the sample axis
        # (px/py are [T,1]; u carries the [T,spp] sample shape)
        shape = u.shape[:-1]
        o = jnp.broadcast_to(self.pixel_origins[px, py], shape + (3,))
        d = jnp.broadcast_to(self.pixel_directions[px, py], shape + (3,))
        w = jnp.ones(shape, jnp.float32)
        return o, d, w


class OpenCVCamera(Observer2D):
    """Camera-matrix + distortion calibrated camera (imaging/opencv.pyx:43).

    ``camera_matrix`` is the OpenCV 3x3 intrinsic matrix [[fx,0,cx],
    [0,fy,cy],[0,0,1]] in pixel units; ``distortion`` the 5-vector
    (k1, k2, p1, p2, k3). Pixel (px, py) maps to normalised coordinates,
    the radial/tangential distortion is inverted with a fixed-point
    iteration (jit-friendly), and the ray leaves the aperture through the
    undistorted image-plane point.
    """

    _rays_per_sample = 2

    def __init__(self, camera_matrix, distortion=None, pixels=(640, 480),
                 frame_sampler=None, pipelines=None, parent=None,
                 transform=None, name=None):
        camera_matrix = np.asarray(camera_matrix, np.float64)
        if camera_matrix.shape != (3, 3):
            raise ValueError("camera_matrix must be 3x3.")
        distortion = (np.zeros(5) if distortion is None
                      else np.asarray(distortion, np.float64).reshape(-1))
        if distortion.shape[0] not in (4, 5):
            raise ValueError("distortion must have 4 or 5 coefficients.")
        if distortion.shape[0] == 4:
            distortion = np.concatenate([distortion, [0.0]])
        pipelines = pipelines if pipelines is not None else [RGBPipeline2D()]
        super().__init__(
            pixels=pixels, frame_sampler=frame_sampler, pipelines=pipelines,
            parent=parent, transform=transform, name=name,
        )
        self.camera_matrix = camera_matrix
        self.distortion = distortion

    def _kernel_cache_extra(self):
        return (tuple(self.camera_matrix.ravel()), tuple(self.distortion))

    def _generate_rays_device(self, px, py, u):
        fx = self.camera_matrix[0, 0]
        fy = self.camera_matrix[1, 1]
        cx = self.camera_matrix[0, 2]
        cy = self.camera_matrix[1, 2]
        k1, k2, p1, p2, k3 = self.distortion
        dtype = jnp.float32
        # jittered distorted pixel -> normalised camera coordinates
        xd = (px.astype(dtype) + u[..., 0] - cx) / fx
        yd = (py.astype(dtype) + u[..., 1] - cy) / fy
        # invert the distortion by fixed-point iteration (x = xd / D(x))
        x, y = xd, yd
        for _ in range(5):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        direction = vmath_normalise_stack(x, y)
        origin = jnp.zeros_like(direction)
        weight = direction[..., 2]
        return origin, direction, weight


def vmath_normalise_stack(x, y):
    from ...core.math import batch as _vm

    return _vm.normalise(jnp.stack([x, y, jnp.ones_like(x)], axis=-1))


class TargetedCCDArray(CCDArray):
    """CCD with targeted direction sampling toward named primitives
    (imaging/targeted_ccd.pyx:46): a fraction of samples aim uniform cones
    at each target's bounding sphere, the rest sample the cosine
    hemisphere; both are weighted by the mixture pdf (one-sample MIS)."""

    _rays_per_sample = 6

    def __init__(self, targets, targeted_path_prob=0.9, **kwargs):
        super().__init__(**kwargs)
        if not targets:
            raise ValueError("At least one target primitive is required.")
        if not 0 < targeted_path_prob <= 1:
            raise ValueError("targeted_path_prob must lie in (0, 1].")
        self.targets = list(targets)
        self.targeted_path_prob = float(targeted_path_prob)

    def _targets_local(self):
        out = []
        for t in self.targets:
            centre, radius = t.bounding_sphere()
            c = centre.transform(self.to_local())
            out.append((c.x, c.y, c.z, radius))
        return tuple(out)

    def _kernel_cache_extra(self):
        return self._targets_local()

    def _generate_rays_device(self, px, py, u):
        import math as _m

        from ...core.math import batch as _vm

        nx, ny = self.pixels
        delta = self._width / nx
        sx = 0.5 * nx * delta
        sy = 0.5 * ny * delta
        dtype = jnp.float32
        ox = sx - delta * (px.astype(dtype) + 0.5) + (u[..., 0] - 0.5) * delta
        oy = sy - delta * (py.astype(dtype) + 0.5) + (u[..., 1] - 0.5) * delta
        origin = jnp.stack([ox, oy, jnp.zeros_like(ox)], axis=-1)

        targets = jnp.asarray(self._targets_local(), dtype)  # [K, 4]
        K = targets.shape[0]
        to_c = targets[None, None, :, :3] - origin[..., None, :]  # [...,K,3]
        dist = jnp.sqrt(jnp.sum(to_c * to_c, axis=-1) + 1e-30)
        axis = to_c / dist[..., None]
        radius = targets[:, 3]
        sin2 = jnp.clip((radius / dist) ** 2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.clip(1.0 - sin2, 0.0, 1.0))
        cos_max = jnp.where(dist <= radius, -1.0, cos_max)

        # pick a target uniformly, then cone-sample it
        t_idx = jnp.clip((u[..., 4] * K).astype(jnp.int32), 0, K - 1)
        ax = jnp.take_along_axis(axis, t_idx[..., None, None], axis=-2)[..., 0, :]
        cm = jnp.take_along_axis(cos_max, t_idx[..., None], axis=-1)[..., 0]
        local_cone = vrand.vector_cone_uniform(u[..., 2], u[..., 3], cm)
        t_f, b_f, n_f = _vm.make_frame(ax)
        d_cone = _vm.from_frame(local_cone, t_f, b_f, n_f)
        d_cos = vrand.vector_hemisphere_cosine(u[..., 2], u[..., 3])
        p = self.targeted_path_prob
        pick_cone = u[..., 5] < p
        direction = jnp.where(pick_cone[..., None], d_cone, d_cos)

        # mixture pdf over all targets + ambient
        cos_theta = jnp.clip(direction[..., 2], 0.0, 1.0)
        pdf_cos = cos_theta / _m.pi
        cos_to = jnp.sum(direction[..., None, :] * axis, axis=-1)  # [...,K]
        solid_angle = 2.0 * _m.pi * (1.0 - cos_max)
        pdf_cone_k = jnp.where(
            cos_to >= cos_max, 1.0 / jnp.maximum(solid_angle, 1e-12), 0.0
        )
        pdf = p * jnp.mean(pdf_cone_k, axis=-1) + (1.0 - p) * pdf_cos
        ok = (pdf > 1e-12) & (direction[..., 2] > 0.0)
        weight = jnp.where(ok, pdf_cos / jnp.maximum(pdf, 1e-12), 0.0)
        return origin, direction, weight
