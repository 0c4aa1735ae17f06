"""Staged fiducial round registration (counterpart of the round-registration
half of ``merfish3d_tpu/ops/registration.py``):

stage 1: phase correlation of the max-z projections → lateral shift;
stage 2: translate the moving volume by that estimate (clamped to a static
margin), then 3D phase correlation of the interior window → the residual
shift; the composition is exact.

The transforms are 4x4 physical (µm) translations mapping fixed
coordinates to moving ones (the convention of :mod:`.warp`). Rounds run
one after another on the device, so memory holds one round's transform
working set at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import to_device, to_host
from .device import as_device_tensor
from .phase_corr import phase_cross_correlation
from .warp import translate_volume


def _static_margin(n: int, cap: int = 64) -> int:
    """Stage-2 crop margin for an axis of length ``n``: a quarter of the
    axis, capped, floored to a multiple of 8."""
    return max((min(n // 4, cap) // 8) * 8, 0)


@torch.no_grad()
def _register_rounds_program(
    fixed: torch.Tensor, movings, upsample_factor: int, return_warped: bool
):
    """Staged registration of every moving round against ``fixed``.
    Returns ((R, 3) pull shifts in px, list of u16 warped volumes or
    None), on the device."""
    fixed = fixed.to(torch.float32)
    nz, ny, nx = fixed.shape
    my, mx = _static_margin(ny), _static_margin(nx)
    interior = (
        slice(None),
        slice(my, ny - my) if my else slice(None),
        slice(mx, nx - mx) if mx else slice(None),
    )
    fixed_proj = torch.amax(fixed, dim=0)
    fixed_crop = fixed[interior]
    # the applied stage-1 translation is clamped so rolled wrap-around
    # stays inside the cropped margin; stage 2 measures the remainder
    lim = to_device(
        np.asarray([my - 1 if my else float(ny), mx - 1 if mx else float(nx)], np.float32), fixed.device
    )
    zero = torch.zeros(1, dtype=torch.float32, device=fixed.device)
    shifts, warped = [], []
    for moving in movings:
        moving = moving.to(torch.float32)
        xy_push = phase_cross_correlation(
            fixed_proj, torch.amax(moving, dim=0), upsample_factor=upsample_factor
        )
        applied = torch.cat([zero, torch.maximum(torch.minimum(-xy_push, lim), -lim)])
        moving_xy = translate_volume(moving, applied)
        residual_push = phase_cross_correlation(
            fixed_crop, moving_xy[interior], upsample_factor=upsample_factor
        )
        del moving_xy
        total_pull = -residual_push + applied
        shifts.append(total_pull)
        if return_warped:
            # the datastore keeps u16: cast on the device, half the readback
            out = translate_volume(moving, total_pull)
            warped.append(torch.clamp(out, 0.0, 65535.0).to(torch.int32).to(torch.uint16))
    return torch.stack(shifts), (warped if return_warped else None)


def register_rounds_to_fixed(
    fixed,
    movings,
    *,
    spacing_zyx_um,
    upsample_factor: int = 10,
    return_warped: bool = False,
    device="cuda",
) -> tuple[np.ndarray, "torch.Tensor | None"]:
    """Register a (R, z, y, x) stack of moving rounds against ``fixed``.

    Returns ``(transforms, warped)``: (R, 4, 4) physical µm transforms and,
    with ``return_warped``, the (R, z, y, x) uint16 moving rounds
    resampled into the fixed frame, left on the device (else None).
    Arrays are moved to ``device``; tensors already there pass through
    without a copy."""
    movings = as_device_tensor(movings, device)
    fixed = as_device_tensor(fixed, device)
    if movings.ndim != 4 or tuple(movings.shape[1:]) != tuple(fixed.shape):
        raise ValueError(f"expected (R, *{tuple(fixed.shape)}) movings, got {tuple(movings.shape)}")
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    shifts, warped = _register_rounds_program(fixed, movings, upsample_factor, return_warped)
    shifts_np = to_host(shifts)
    transforms = np.tile(np.eye(4, dtype=np.float32), (len(shifts_np), 1, 1))
    transforms[:, :3, 3] = shifts_np * spacing
    return transforms, (torch.stack(warped) if warped is not None else None)


def register_pair_to_fixed(
    fixed, moving, *, spacing_zyx_um, upsample_factor: int = 10, device="cuda"
) -> np.ndarray:
    """The 4x4 physical transform aligning ``moving`` to ``fixed``."""
    if tuple(fixed.shape) != tuple(moving.shape) or fixed.ndim != 3:
        raise ValueError(f"expected matching 3D shapes, got {fixed.shape} vs {moving.shape}")
    transforms, _ = register_rounds_to_fixed(
        fixed, as_device_tensor(moving, device)[None],
        spacing_zyx_um=spacing_zyx_um, upsample_factor=upsample_factor, device=device,
    )
    return transforms[0]


def registration_binning_from_spacing(spacing_zyx_um) -> dict:
    """Phase-registration binning from voxel spacing: z unbinned, y/x
    binned to roughly isotropic voxels."""
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    if spacing.shape[0] != 3:
        raise ValueError("spacing_zyx_um must have three ZYX elements.")
    return {
        "z": 1,
        "y": max(1, round(float(spacing[0] / spacing[1]))),
        "x": max(1, round(float(spacing[0] / spacing[2]))),
    }
