"""Material modifiers: Roughen, Blend, Add, VolumeTransform.

Counterparts of raysect/optical/material/modifiers/
(roughen.pyx:46-120, blend.pyx:37, add.pyx:36, transform.pyx:36). The
reference wraps materials with delegating evaluate_surface overrides; in
the flat-table dispatch world:

  * ``Roughen`` compiles as its base material's row with the reserved
    roughness slot set — the wavefront kernel perturbs the shading normal
    pre-dispatch (lerp toward a cosine-hemisphere sample, roughen.pyx
    semantics without the rejection loop);
  * ``Blend``/``Add`` compile their children as separate table rows plus a
    remap row: per ray, the kernel rolls the mix before gathering material
    data. ``Add`` uses a 50/50 pick with 2x weight — an unbiased one-sample
    estimator of the summed response (the reference traces both daughters;
    same expectation, slightly higher variance);
  * ``VolumeTransform`` composes an extra affine transform into the
    wrapped material's volume-integration frame (transform.pyx:36).
"""

from __future__ import annotations

import numpy as np

from .base import Material, ROUGHEN_SLOT

__all__ = ["Roughen", "Blend", "Add", "VolumeTransform"]


class _Delegating(Material):
    """Shared delegation plumbing for wrapping modifiers."""

    def __init__(self, material):
        super().__init__()
        self.material = material

    @property
    def MAT_TYPE(self):  # noqa: N802 — mirrors the class attribute contract
        return self.material.MAT_TYPE

    @property
    def VOLUME_KIND(self):  # noqa: N802
        return self.material.VOLUME_KIND

    def compile_params(self):
        return self.material.compile_params()

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        return self.material.compile_spectra(min_wavelength, max_wavelength, bins)

    def compile_scalars(self, min_wavelength, max_wavelength):
        return self.material.compile_scalars(min_wavelength, max_wavelength)

    def child_materials(self):
        return self.material.child_materials()


class Roughen(_Delegating):
    """Perturb the wrapped material's shading normal (roughen.pyx:46).

    roughness in (0, 1]: 0 = no perturbation, 1 = full cosine-hemisphere
    resample of the normal.
    """

    def __init__(self, material, roughness):
        if not 0 <= roughness <= 1:
            raise ValueError("roughness must lie in [0, 1].")
        super().__init__(material)
        self.roughness = float(roughness)

    def compile_params(self):
        p = np.array(self.material.compile_params(), dtype=np.float64)
        p[ROUGHEN_SLOT] = self.roughness
        return p


class _Mix(Material):
    """Base for probabilistic two-material mixes. Compiles as a remap row:
    params[0] = probability of picking material 2."""

    IS_MIX = True
    ADD_WEIGHT = 1.0  # throughput compensation applied to mixed lanes

    def __init__(self, m1, m2, prob_m2):
        super().__init__()
        self.m1 = m1
        self.m2 = m2
        self._prob_m2 = float(prob_m2)

    def child_materials(self):
        return [self.m1, self.m2]

    def compile_params(self):
        from .base import NPARAMS

        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = self._prob_m2
        return p


class Blend(_Mix):
    """Probabilistic blend of two materials (blend.pyx:37): each interaction
    samples material 2 with probability ``ratio``, else material 1; the
    roulette weights cancel so no compensation is applied."""

    def __init__(self, m1, m2, ratio, surface_only=False, volume_only=False):
        if not 0 < ratio < 1:
            raise ValueError("ratio must lie in (0, 1).")
        if surface_only and volume_only:
            raise ValueError("surface_only and volume_only are mutually exclusive.")
        super().__init__(m1, m2, ratio)
        self.ratio = float(ratio)
        self.surface_only = bool(surface_only)
        self.volume_only = bool(volume_only)


class Add(_Mix):
    """Summed response of two materials (add.pyx:36). One-sample estimator:
    pick each child with probability 1/2 and double the contribution —
    unbiased for m1 + m2."""

    ADD_WEIGHT = 2.0

    def __init__(self, m1, m2, surface_only=False, volume_only=False):
        if surface_only and volume_only:
            raise ValueError("surface_only and volume_only are mutually exclusive.")
        super().__init__(m1, m2, 0.5)
        self.surface_only = bool(surface_only)
        self.volume_only = bool(volume_only)


class VolumeTransform(_Delegating):
    """Offset the wrapped material's volume-integration frame
    (transform.pyx:36): volume emission functions are evaluated at
    ``transform.inverse() @ p_local``."""

    def __init__(self, material, transform=None):
        super().__init__(material)
        from ...core.math.affinematrix import AffineMatrix3D

        self.transform = transform if transform is not None else AffineMatrix3D()

    def volume_frame_matrix(self):
        """Extra world->frame matrix composed into volume evaluation."""
        return self.transform.inverse().to_array(np.float64)
