"""Pure-translation warps (counterpart of ``transform_to_pixel`` and
``translate_volume`` in ``merfish3d_tpu/ops/warp.py``).

Physical-transform convention as the reference's: the 4x4
``transform_zyx_um`` maps output/reference physical coordinates to
input/moving ones, with ``matrix_px = (A * s_row) / s_col`` and
``offset_px = (A @ origin + t - origin) / s``. The general affine and
flow warps are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def transform_to_pixel(
    transform_zyx_um: np.ndarray,
    spacing_zyx_um,
    origin_zyx_um=(0.0, 0.0, 0.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a physical 4x4 (reference → moving) to pixel matrix + offset."""
    transform = np.asarray(transform_zyx_um, dtype=np.float32)
    spacing = np.asarray(spacing_zyx_um, dtype=np.float32)
    origin = np.asarray(origin_zyx_um, dtype=np.float32)
    linear = transform[:3, :3]
    translation = transform[:3, 3]
    matrix_px = (linear * spacing[np.newaxis, :]) / spacing[:, np.newaxis]
    offset_px = (linear @ origin + translation - origin) / spacing
    return matrix_px, offset_px


def translate_volume(vol: torch.Tensor, shift_pull_px, cval: float = 0.0) -> torch.Tensor:
    """Sub-pixel translation ``out[p] = vol[p + shift]`` (pull shift),
    ``cval`` outside: per axis one linear blend of two shifted copies,
    exactly order-1 ``map_coordinates`` in constant mode. ``shift_pull_px``
    may be a tensor on the volume's device; nothing is read back to the
    host."""
    out = vol.to(torch.float32)
    shift = torch.as_tensor(shift_pull_px, dtype=torch.float32, device=vol.device)
    for ax in range(vol.ndim):
        n = vol.shape[ax]
        s = shift[ax]
        i = torch.floor(s)
        f = s - i
        pos = torch.arange(n, device=vol.device) + i.to(torch.int64)
        shape = [1] * vol.ndim
        shape[ax] = n
        valid_a = ((pos >= 0) & (pos <= n - 1)).reshape(shape)
        valid_b = ((pos + 1 >= 0) & (pos + 1 <= n - 1)).reshape(shape)
        a = out.index_select(ax, pos.clamp(0, n - 1))
        b = out.index_select(ax, (pos + 1).clamp(0, n - 1))
        out = (1.0 - f) * torch.where(valid_a, a, cval) + f * torch.where(valid_b, b, cval)
    return out
