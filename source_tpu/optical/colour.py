"""CIE colour pipeline.

Vectorised re-design of raysect/optical/colour.pyx. Instead of carrying the
5 nm CIE lookup tables, the CIE 1931 2-degree colour matching functions are
evaluated with the multi-lobe piecewise-Gaussian analytic fit of Wyman, Sloan
& Shirley (JCGT 2013) — accurate to well under 1 % of peak, smooth, and
differentiable, which matters because pixel gradients flow through the
spectrum -> XYZ contraction. The same normalisation as the reference is
applied (tables divided by 106.8566 so the Y curve integrates to 1 —
colour.pyx:39-81), so radiance -> XYZ magnitudes agree.

Batched usage: ``spectra_to_ciexyz(samples[N, B], resampled[B, 3])`` is a
single matmul-shaped contraction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .spectrum import InterpolatedSF, Spectrum, wavelength_grid

__all__ = [
    "ciexyz_x",
    "ciexyz_y",
    "ciexyz_z",
    "resample_ciexyz",
    "spectrum_to_ciexyz",
    "spectra_to_ciexyz",
    "ciexyy_to_ciexyz",
    "ciexyz_to_ciexyy",
    "ciexyz_to_srgb",
    "srgb_to_ciexyz",
    "srgb_transfer_function",
    "srgb_transfer_function_inverse",
    "d65_white",
]

# reference table normalisation: CIE y-bar integral over wavelength in nm
_CIE_NORM = 106.8566


def _gauss(w, mu, s1, s2):
    """Piecewise gaussian with distinct left/right widths."""
    s = jnp.where(w < mu, s1, s2)
    t = (w - mu) / s
    return jnp.exp(-0.5 * t * t)


def cie_x_bar(w):
    """CIE 1931 x-bar CMF, analytic fit (Wyman et al. 2013, eq. 2)."""
    return (
        1.056 * _gauss(w, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(w, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(w, 501.1, 20.4, 26.2)
    )


def cie_y_bar(w):
    return 0.821 * _gauss(w, 568.8, 46.9, 40.5) + 0.286 * _gauss(w, 530.9, 16.3, 31.1)


def cie_z_bar(w):
    return 1.217 * _gauss(w, 437.0, 11.8, 36.0) + 0.681 * _gauss(w, 459.0, 26.0, 13.8)


class _AnalyticCMF:
    """SpectralFunction-like wrapper over an analytic CMF (normalised)."""

    def __init__(self, fn):
        self._fn = fn

    def evaluate(self, wavelength):
        return float(self._fn(jnp.asarray(wavelength))) / _CIE_NORM

    __call__ = evaluate

    def sample(self, min_wavelength, max_wavelength, bins):
        """Per-bin average via 4-point sub-bin quadrature."""
        edges = np.linspace(min_wavelength, max_wavelength, bins + 1)
        # 4-point midpoint rule inside each bin
        offs = (np.arange(4) + 0.5) / 4.0
        w = edges[:-1, None] + (edges[1:] - edges[:-1])[:, None] * offs[None, :]
        vals = np.asarray(self._fn(jnp.asarray(w)))
        return vals.mean(axis=1) / _CIE_NORM

    def integrate(self, min_wavelength, max_wavelength):
        s = self.sample(min_wavelength, max_wavelength, 64)
        return float(s.sum() * (max_wavelength - min_wavelength) / 64)


ciexyz_x = _AnalyticCMF(cie_x_bar)
ciexyz_y = _AnalyticCMF(cie_y_bar)
ciexyz_z = _AnalyticCMF(cie_z_bar)


def resample_ciexyz(min_wavelength, max_wavelength, bins):
    """Pre-sample the XYZ sensitivity curves onto a spectral grid -> [bins, 3]
    (colour.pyx:123)."""
    if bins < 1:
        raise ValueError("Number of samples can not be less than 1.")
    if min_wavelength <= 0.0 or max_wavelength <= 0.0:
        raise ValueError("Wavelength can not be less than or equal to zero.")
    if min_wavelength >= max_wavelength:
        raise ValueError("Minimum wavelength must be less than the maximum wavelength.")
    w = wavelength_grid(min_wavelength, max_wavelength, bins, dtype=jnp.float64 if False else jnp.float32)
    xyz = jnp.stack([cie_x_bar(w), cie_y_bar(w), cie_z_bar(w)], axis=-1) / _CIE_NORM
    return xyz


def spectra_to_ciexyz(samples, resampled_xyz, delta_wavelength):
    """Batched spectrum -> XYZ: samples [..., B] x resampled [B, 3] -> [..., 3]
    (colour.pyx:158 semantics; one contraction, pinned to f32 so the GPU
    does not round the radiometry to TF32)."""
    return jnp.matmul(samples, resampled_xyz,
                      precision=jax.lax.Precision.HIGHEST) * delta_wavelength


def spectrum_to_ciexyz(spectrum: Spectrum, resampled_xyz=None):
    """Single-spectrum convenience wrapper returning (x, y, z)."""
    if resampled_xyz is None:
        resampled_xyz = resample_ciexyz(
            spectrum.min_wavelength, spectrum.max_wavelength, spectrum.bins
        )
    xyz = spectra_to_ciexyz(spectrum.samples, resampled_xyz, spectrum.delta_wavelength)
    return float(xyz[0]), float(xyz[1]), float(xyz[2])


def ciexyy_to_ciexyz(cx, cy, y):
    """CIE xyY -> XYZ (colour.pyx:195)."""
    return y / cy * cx, y, y / cy * (1 - cx - cy)


def ciexyz_to_ciexyy(x, y, z):
    """CIE XYZ -> xyY."""
    n = x + y + z
    return x / n, y / n, y


def srgb_transfer_function(v):
    """Linear -> gamma-encoded sRGB (colour.pyx srgb_transfer_function)."""
    v = jnp.asarray(v)
    return jnp.where(
        v <= 0.0031308,
        12.92 * v,
        1.055 * jnp.maximum(v, 1e-12) ** (1.0 / 2.4) - 0.055,
    )


def srgb_transfer_function_inverse(v):
    v = jnp.asarray(v)
    return jnp.where(
        v <= 0.04045,
        v / 12.92,
        ((v + 0.055) / 1.055) ** 2.4,
    )


# sRGB D65 matrices (IEC 61966-2-1, same coefficients as colour.pyx:235)
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=jnp.float32,
)
_SRGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=jnp.float32,
)


def ciexyz_to_srgb(x, y=None, z=None):
    """XYZ -> gamma-encoded sRGB, clamped to [0, 1]. Accepts either a
    batched [..., 3] array or three scalars (reference signature)."""
    scalar = y is not None
    xyz = jnp.stack([jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)], axis=-1) if scalar else jnp.asarray(x)
    rgb = jnp.einsum("ij,...j->...i", _XYZ_TO_SRGB, xyz, precision="highest")
    rgb = srgb_transfer_function(jnp.clip(rgb, 0.0, None))
    rgb = jnp.clip(rgb, 0.0, 1.0)
    if scalar:
        return float(rgb[..., 0]), float(rgb[..., 1]), float(rgb[..., 2])
    return rgb


def srgb_to_ciexyz(r, g=None, b=None):
    """Gamma-encoded sRGB -> XYZ (inverse of ciexyz_to_srgb)."""
    scalar = g is not None
    rgb = jnp.stack([jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)], axis=-1) if scalar else jnp.asarray(r)
    lin = srgb_transfer_function_inverse(rgb)
    xyz = jnp.einsum("ij,...j->...i", _SRGB_TO_XYZ, lin, precision="highest")
    if scalar:
        return float(xyz[..., 0]), float(xyz[..., 1]), float(xyz[..., 2])
    return xyz


# CIE D65 standard illuminant, 10 nm tabulation (standard public data),
# normalised like the reference d65_white (colour.pyx:118) so its *mean*
# over the visual range 375-785 nm is ~1.
_D65_W = np.arange(380.0, 790.0, 10.0)
_D65_S = np.array(
    [
        49.98, 54.65, 82.75, 91.49, 93.43, 86.68, 104.86, 117.01, 117.81,
        114.86, 115.92, 108.81, 109.35, 107.80, 104.79, 104.41, 100.00,
        96.33, 95.79, 88.69, 90.01, 89.60, 87.70, 83.29, 83.70, 80.03,
        80.21, 82.28, 78.28, 69.72, 71.61, 74.35, 61.60, 69.89, 75.09,
        63.59, 46.42, 66.81, 63.38, 64.30, 59.45,
    ]
)
d65_white = InterpolatedSF(_D65_W, _D65_S / 87.1971)
