"""Phase cross-correlation (counterpart of the registration half of
``merfish3d_tpu/ops/phase_corr.py``):

- phase-normalized cross-power spectrum (:mod:`.fftutils`, so 3D volumes
  go through the DFT kernels) and the argmax of its inverse for the
  integer shift,
- disambiguation over the 2^d wrap candidates (shift or shift ∓ size) by
  masked normalized cross-correlation of the rolled overlap, one
  candidate after another so the rolled volumes never coexist,
- Guizar-Sicairos upsampled-DFT refinement as small dense products over
  the frequency axes (``torch.tensordot`` in full FP32).

Shift convention as skimage's: the returned "push" shift applied to
``moving`` aligns it to ``fixed``. The stitching half (``ssim``,
``register_translation_with_quality``) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import read_list, read_scalar, to_device
from .fftutils import c_conj, c_mul, fftn_spec, ifftn_spec, spectrum_freqs


def _cross_power_spectrum(fixed: torch.Tensor, moving: torch.Tensor):
    """Phase-normalized cross-power spectrum as a (real, imag) pair in the
    spectrum order of :func:`.fftutils.fftn_spec`."""
    F = fftn_spec(fixed.to(torch.float32))
    M = fftn_spec(moving.to(torch.float32))
    rr, ri = c_mul(F, c_conj(M))
    mag = torch.clamp(torch.sqrt(rr * rr + ri * ri), min=1e-20)
    return rr / mag, ri / mag


def _unravel(flat: torch.Tensor, shape) -> torch.Tensor:
    """Index tuple of a flat index (row-major) as a float32 vector."""
    idx = []
    for n in reversed(shape):
        idx.append(flat % n)
        flat = torch.div(flat, n, rounding_mode="floor")
    return torch.stack(idx[::-1]).to(torch.float32)


def _integer_peak(corr_abs: torch.Tensor) -> torch.Tensor:
    """Argmax of |ifft| unwrapped to signed shifts (the first maximum, as
    ``jnp.argmax``)."""
    idx = _unravel(torch.argmax(corr_abs), corr_abs.shape)
    shape = to_device(np.asarray(corr_abs.shape, np.int64), corr_abs.device)
    return torch.where(idx > torch.div(shape, 2, rounding_mode="floor"), idx - shape, idx)


def _upsampled_dft(cross_power_pair, shifts: torch.Tensor, upsample_factor: int) -> torch.Tensor:
    """Refine the peak on an upsampled local DFT grid around ``shifts``:
    one frequency axis at a time, the inverse DFT evaluated at ``region``
    fractional sample positions, then the argmax of its magnitude."""
    up = float(upsample_factor)
    region = int(np.ceil(up * 1.5))
    dftshift = region // 2
    dr, di = cross_power_pair
    dev = dr.device
    for axis in range(dr.ndim):
        n = dr.shape[0]  # current leading axis (axes roll as we go)
        freqs = to_device(spectrum_freqs(n), dev)
        sample_pos = (torch.arange(region, dtype=torch.float32, device=dev) - dftshift) / up
        sample_pos = sample_pos + shifts[axis]
        # kernel[r, f] = exp(2πi freqs[f] sample_pos[r])
        angle = 2.0 * math.pi * sample_pos[:, None] * freqs[None, :]
        kr, ki = torch.cos(angle), torch.sin(angle)
        nr = torch.tensordot(kr, dr, dims=([1], [0])) - torch.tensordot(ki, di, dims=([1], [0]))
        ni = torch.tensordot(kr, di, dims=([1], [0])) + torch.tensordot(ki, dr, dims=([1], [0]))
        # the new region axis goes to the back: axis 0 is the next frequency axis
        dr, di = torch.movedim(nr, 0, -1), torch.movedim(ni, 0, -1)
    local = torch.sqrt(dr * dr + di * di)
    loc = _unravel(torch.argmax(local), local.shape)
    return shifts + (loc - dftshift) / up


def _roll_with_validity(moving: torch.Tensor, shift: torch.Tensor):
    """Roll by the rounded shift (half to even) and build the wrap-validity
    mask."""
    ishift = [int(v) for v in read_list(torch.round(shift).to(torch.int64))]
    rolled = torch.roll(moving, shifts=ishift, dims=tuple(range(moving.ndim)))
    mask = torch.ones(moving.shape, dtype=torch.float32, device=moving.device)
    for ax, s in enumerate(ishift):
        n = moving.shape[ax]
        shape = [1] * moving.ndim
        shape[ax] = n
        pos = torch.arange(n, device=moving.device).reshape(shape)
        valid = pos >= s if s >= 0 else pos < n + s
        mask = mask * valid.to(torch.float32)
    return rolled, mask


def _masked_ncc_for_shift(fixed: torch.Tensor, moving: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Normalized cross-correlation of the valid overlap after rolling
    ``moving`` by ``shift``."""
    rolled, mask = _roll_with_validity(moving, shift)
    w = torch.clamp(torch.sum(mask), min=1.0)
    fm = torch.sum(fixed * mask) / w
    mm = torch.sum(rolled * mask) / w
    fc = (fixed - fm) * mask
    mc = (rolled - mm) * mask
    denom = torch.sqrt(torch.sum(fc * fc) * torch.sum(mc * mc))
    return torch.sum(fc * mc) / torch.clamp(denom, min=1e-12)


def phase_cross_correlation(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    upsample_factor: int = 10,
    disambiguate: bool = True,
) -> torch.Tensor:
    """Estimate the (push) translation aligning ``moving`` to ``fixed``:
    float32 shifts, one per axis, on the inputs' device, sub-pixel refined
    when ``upsample_factor > 1``."""
    fixed = fixed.to(torch.float32)
    moving = moving.to(torch.float32)
    R = _cross_power_spectrum(fixed, moving)
    cr, ci = ifftn_spec(*R)
    shift = _integer_peak(torch.sqrt(cr * cr + ci * ci))
    del cr, ci

    if disambiguate:
        # the 2^d sign-wrap candidates: shift, or shift -/+ size per axis
        size = to_device(np.asarray(fixed.shape, np.float32), fixed.device)
        wrapped = torch.where(shift >= 0, shift - size, shift + size)
        cands = torch.stack([
            torch.where(
                to_device(np.asarray([(bits >> ax) & 1 for ax in range(fixed.ndim)], np.int64), fixed.device)
                > 0, wrapped, shift,
            )
            for bits in range(2**fixed.ndim)
        ])
        # scored one after another: the rolled volumes never coexist
        nccs = torch.stack([_masked_ncc_for_shift(fixed, moving, c) for c in cands])
        shift = cands[read_scalar(torch.argmax(nccs))]

    if upsample_factor > 1:
        shift = torch.round(shift * upsample_factor) / upsample_factor
        shift = _upsampled_dft(R, shift, upsample_factor)
    return shift.to(torch.float32)
