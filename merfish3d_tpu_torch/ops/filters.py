"""Separable Gaussian lowpass (counterpart of ``merfish3d_tpu/ops/filters.py``).

Plain torch on any device: each axis is a weighted sum of shifted views
of a symmetrically padded copy. The pad is built by index with numpy's
``"symmetric"`` map (scipy.ndimage's ``"reflect"``, which repeats the
edge sample); torch's ``F.pad(mode="reflect")`` is numpy's ``"reflect"``,
which does not, so it is not used.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import to_device


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Matches scipy.ndimage.gaussian_filter1d kernel construction."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def symmetric_pad_index(n: int, before: int, after: int) -> np.ndarray:
    """Source index of every sample of ``np.pad(a, (before, after),
    mode="symmetric")`` along an axis of length ``n`` (any pad width)."""
    return np.pad(np.arange(n), (before, after), mode="symmetric")


def pad_symmetric(vol: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    idx = to_device(symmetric_pad_index(vol.shape[axis], before, after), vol.device)
    return vol.index_select(axis, idx)


def _conv_axis(vol: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    r = (len(kernel) - 1) // 2
    n = vol.shape[axis]
    padded = pad_symmetric(vol, axis, r, r)
    out = padded.narrow(axis, 0, n) * float(kernel[0])
    for k in range(1, len(kernel)):
        out.add_(padded.narrow(axis, k, n), alpha=float(kernel[k]))
    return out


def gaussian_lowpass(
    volume: torch.Tensor, sigma=(3.0, 1.0, 1.0), truncate: float = 4.0
) -> torch.Tensor:
    """Separable Gaussian filter over the trailing 3 dims (z, y, x), with
    scipy's ``reflect`` boundary; sigma 0 skips an axis. Returns float32
    on the input's device."""
    vol = volume.to(torch.float32)
    lead = vol.ndim - 3
    for ax, s in enumerate(sigma):
        if s and s > 0:
            vol = _conv_axis(vol, _gaussian_kernel1d(float(s), truncate), lead + ax)
    return vol
