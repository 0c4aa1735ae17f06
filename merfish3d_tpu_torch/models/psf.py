"""Theoretical PSFs (the port's own copy of ``merfish3d_tpu/models/psf.py``,
numpy and scipy only).

A Gaussian approximation of the widefield PSF (Zhang et al. 2007 paraxial
constants), a scalar Born-Wolf model and a vectorial widefield model,
both by numerical quadrature. :func:`make_channel_psfs` builds a store's
``channel_psfs``.
"""

from __future__ import annotations

import numpy as np


def gaussian_psf(
    *,
    emission_wavelength_um: float,
    na: float,
    ri: float,
    voxel_size_zyx_um,
    shape_zyx: tuple[int, int, int] = (31, 31, 31),
) -> np.ndarray:
    """Anisotropic Gaussian PSF with paraxial widths
    sigma_xy = 0.21 λ/NA, sigma_z = 0.66 λ n / NA²."""
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


def born_wolf_psf(
    *,
    emission_wavelength_um: float,
    na: float,
    ri: float,
    voxel_size_zyx_um,
    shape_zyx: tuple[int, int, int] = (31, 31, 31),
    n_rho: int = 128,
) -> np.ndarray:
    """Scalar Born-Wolf PSF: |∫ J0(k·NA·ρ·r) exp(-i k ρ² z NA²/(2n)) ρ dρ|²,
    evaluated on the voxel grid by trapezoidal quadrature (radially symmetric
    in-plane)."""
    from scipy.special import j0

    spacing = np.asarray(voxel_size_zyx_um, dtype=np.float64)
    nz, ny, nx = shape_zyx
    k = 2.0 * np.pi / float(emission_wavelength_um)
    z = (np.arange(nz) - nz // 2) * spacing[0]
    y = (np.arange(ny) - ny // 2) * spacing[1]
    x = (np.arange(nx) - nx // 2) * spacing[2]
    rr = np.sqrt(y[:, None] ** 2 + x[None, :] ** 2)  # (ny, nx)
    rho = np.linspace(0.0, 1.0, n_rho)
    # (nz, n_rho) defocus phase
    defocus = np.exp(
        -1j * k * (rho[None, :] ** 2) * z[:, None] * (na**2) / (2.0 * ri)
    )
    # radial bessel term (ny*nx, n_rho)
    bess = j0(k * na * rho[None, :] * rr.reshape(-1, 1))
    integrand = bess[None, :, :] * defocus[:, None, :] * rho[None, None, :]
    field = np.trapezoid(integrand, rho, axis=-1)
    psf = np.abs(field.reshape(nz, ny, nx)) ** 2
    return (psf / psf.sum()).astype(np.float32)


def vectorial_psf(
    *,
    emission_wavelength_um: float,
    na: float,
    ri: float,
    voxel_size_zyx_um,
    shape_zyx: tuple[int, int, int] = (31, 31, 31),
    ns: float = 1.47,
    n_theta: int = 256,
) -> np.ndarray:
    """Vectorial widefield PSF (Richards-Wolf with an immersion→sample
    interface, the model family psfmodels' ``model="vectorial"`` evaluates
    — reference `chromatic.py:468-487` uses ``ns=1.47, ni=ri``).

    Focal field components for an emitter at the coverslip (psfmodels'
    default ``pz=0``), aperture integral over the incidence angle θ:

        I0 = ∫ √cosθ sinθ (ts + tp·cosθs)        J0(k·ni·r·sinθ) e^{iΦ} dθ
        I1 = ∫ √cosθ sinθ  sinθi·tp·(ni/ns)      J1(k·ni·r·sinθ) e^{iΦ} dθ
        I2 = ∫ √cosθ sinθ (ts − tp·cosθs)        J2(k·ni·r·sinθ) e^{iΦ} dθ
        PSF ∝ |I0|² + 2|I1|² + |I2|²,  Φ = k·z·ni·cosθ

    with Fresnel transmissions ts/tp at the ni→ns interface and
    sinθs = (ni/ns)·sinθ (Snell). Radially symmetric in-plane; evaluated
    by trapezoidal quadrature on the voxel grid like :func:`born_wolf_psf`.
    """
    from scipy.special import j0, j1, jv

    ni = float(ri)
    ns = float(ns)
    spacing = np.asarray(voxel_size_zyx_um, dtype=np.float64)
    nz, ny, nx = shape_zyx
    k = 2.0 * np.pi / float(emission_wavelength_um)
    alpha = np.arcsin(min(na / ni, 1.0))
    theta = np.linspace(0.0, alpha, n_theta)
    sin_t = np.sin(theta)
    cos_t = np.cos(theta)
    # Snell into the sample; evanescent components clamped out
    sin_s = np.clip(ni / ns * sin_t, 0.0, 1.0)
    cos_s = np.sqrt(np.maximum(1.0 - sin_s**2, 0.0))
    ts = 2.0 * ni * cos_t / np.maximum(ni * cos_t + ns * cos_s, 1e-12)
    tp = 2.0 * ni * cos_t / np.maximum(ni * cos_s + ns * cos_t, 1e-12)
    apod = np.sqrt(np.maximum(cos_t, 0.0)) * sin_t

    z = (np.arange(nz) - nz // 2) * spacing[0]
    y = (np.arange(ny) - ny // 2) * spacing[1]
    x = (np.arange(nx) - nx // 2) * spacing[2]
    rr = np.sqrt(y[:, None] ** 2 + x[None, :] ** 2).reshape(-1)  # (ny*nx,)

    phase = np.exp(1j * k * ni * np.outer(z, cos_t))  # (nz, n_theta)
    arg = k * ni * np.outer(rr, sin_t)  # (ny*nx, n_theta)
    b0 = j0(arg)
    b1 = j1(arg)
    b2 = jv(2, arg)
    w0 = apod * (ts + tp * cos_s)
    w1 = apod * sin_t * tp * (ni / ns)
    w2 = apod * (ts - tp * cos_s)

    def integral(bess, w):
        integrand = bess[None, :, :] * (w[None, None, :] * phase[:, None, :])
        return np.trapezoid(integrand, theta, axis=-1)  # (nz, ny*nx)

    i0 = integral(b0, w0)
    i1 = integral(b1, w1)
    i2 = integral(b2, w2)
    psf = (np.abs(i0) ** 2 + 2.0 * np.abs(i1) ** 2 + np.abs(i2) ** 2).reshape(
        nz, ny, nx
    )
    return (psf / psf.sum()).astype(np.float32)


def make_channel_psfs(
    emission_wavelengths_um,
    *,
    na: float,
    ri: float,
    voxel_size_zyx_um,
    shape_zyx: tuple[int, int, int] = (31, 31, 31),
    model: str = "gaussian",
) -> list[np.ndarray]:
    """One PSF per channel emission wavelength (the datastore
    ``channel_psfs`` manifest; reference `create_datastore.py`).

    ``model``: "gaussian" | "born_wolf" | "vectorial" (the reference's
    bead-calibration path uses psfmodels vectorial, `chromatic.py:468-487`).
    """
    fn = {
        "gaussian": gaussian_psf,
        "born_wolf": born_wolf_psf,
        "vectorial": vectorial_psf,
    }[model]
    return [
        fn(
            emission_wavelength_um=wl,
            na=na,
            ri=ri,
            voxel_size_zyx_um=voxel_size_zyx_um,
            shape_zyx=shape_zyx,
        )
        for wl in emission_wavelengths_um
    ]
