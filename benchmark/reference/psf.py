"""The channel PSFs a store carries: the Gaussian approximation of the
widefield PSF (Zhang et al. 2007 paraxial constants), as the program's
``models/psf.py`` builds them for a simulated acquisition."""

from __future__ import annotations

import numpy as np


def gaussian_psf(*, emission_wavelength_um: float, na: float, ri: float, voxel_size_zyx_um,
                 shape_zyx: tuple[int, int, int]) -> np.ndarray:
    """Anisotropic Gaussian PSF with paraxial widths
    sigma_xy = 0.21 λ/NA, sigma_z = 0.66 λ n / NA², unit sum."""
    wl = float(emission_wavelength_um)
    sigma_xy_um = 0.21 * wl / na
    sigma_z_um = 0.66 * wl * ri / (na * na)
    spacing = np.asarray(voxel_size_zyx_um, dtype=np.float64)
    sz, sy, sx = sigma_z_um / spacing[0], sigma_xy_um / spacing[1], sigma_xy_um / spacing[2]
    zz, yy, xx = np.meshgrid(
        *[np.arange(s, dtype=np.float64) - s // 2 for s in shape_zyx], indexing="ij"
    )
    psf = np.exp(-0.5 * ((zz / sz) ** 2 + (yy / sy) ** 2 + (xx / sx) ** 2))
    return (psf / psf.sum()).astype(np.float32)


def make_channel_psfs(emission_wavelengths_um, *, na: float, ri: float, voxel_size_zyx_um,
                      shape_zyx: tuple[int, int, int]) -> list[np.ndarray]:
    """One PSF per channel emission wavelength."""
    return [gaussian_psf(emission_wavelength_um=wl, na=na, ri=ri, voxel_size_zyx_um=voxel_size_zyx_um,
                         shape_zyx=shape_zyx) for wl in emission_wavelengths_um]
