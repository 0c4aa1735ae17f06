"""Region properties of decoded components (counterpart of the numpy
half of ``merfish3d_tpu/ops/cc.py``: :func:`component_stats_host`,
:func:`inertia_tensor_eigvals`).

Copied rather than imported: the JAX package cannot be imported without
JAX. The sums come from :mod:`.components` on the tensors' device (the
card's kernels, or their plain versions on a CPU tensor), and numpy only
derives the statistics from the rows that come down.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .components import GEOMETRY_COLUMNS, component_sums


def component_stats_host(
    decoded: torch.Tensor,  # (Z, Y, X) int16, -1 background
    labels: tuple[torch.Tensor, torch.Tensor],  # label_components' (lin, roots)
    distance: torch.Tensor,  # (Z, Y, X) float16
    magnitude: torch.Tensor,  # (Z, Y, X) float16
    scaled: torch.Tensor,  # (bits, Z, Y, X) float16 or float32
    *,
    collect_weighted_centroids: bool = False,
    size_window: Optional[tuple[float, float]] = None,
) -> dict:
    """Regionprops over the assigned voxels only: area, centroid,
    codeword, min distance, mean magnitude, per-bit sums and means and
    central second moments per component; with
    ``collect_weighted_centroids`` also ``bit_w_coord_sums`` (bits, n, 3),
    each bit's intensity-weighted z, y, x sums (the chromatic estimator's
    per-bit centroids). With ``size_window = (least, most)`` only the
    components of that many voxels are returned.

    The sums are :func:`..ops.components.component_sums` on the tensors'
    device, the JAX package's ``np.bincount`` sums bit for bit, and only
    the window's rows come to the host."""
    rows = component_sums(
        decoded, labels, distance, magnitude, scaled,
        weighted=collect_weighted_centroids, size_window=size_window,
    )
    bits, g = scaled.shape[0], len(GEOMETRY_COLUMNS)
    sums = {name: rows[:, i] for i, name in enumerate(GEOMETRY_COLUMNS)}
    sums["codeword"] = sums["codeword"].astype(np.int32)
    sums["bits"] = rows[:, g:g + bits].T
    if collect_weighted_centroids:
        sums["bits_zyx"] = rows[:, g + bits:].reshape(-1, bits, 3).transpose(1, 0, 2)
    return _stats_from_sums(sums, collect_weighted_centroids)


def _stats_from_sums(sums: dict, collect_weighted_centroids: bool) -> dict:
    """The statistics of :func:`component_stats_host` from a component's
    float64 sums: ``area``, ``z``/``y``/``x``, the second moments ``zz`` ..
    ``yx``, ``magnitude_sum``, ``distance_min``, ``codeword``, ``bits``
    (bits, n) and, with ``collect_weighted_centroids``, ``bits_zyx``
    (bits, n, 3)."""
    area = sums["area"]
    n = area.shape[0]
    safe = np.maximum(area, 1.0)
    cz, cy, cx = sums["z"] / safe, sums["y"] / safe, sums["x"] / safe
    bit_sums = sums["bits"]
    bit_means = bit_sums / safe[None, :]

    m_zz = sums["zz"] / safe - cz * cz
    m_yy = sums["yy"] / safe - cy * cy
    m_xx = sums["xx"] / safe - cx * cx
    m_zy = sums["zy"] / safe - cz * cy
    m_zx = sums["zx"] / safe - cz * cx
    m_yx = sums["yx"] / safe - cy * cx

    out = {
        "valid": np.ones(n, bool),
        "area": area.astype(np.float32),
        "centroid_zyx": np.stack([cz, cy, cx], axis=1).astype(np.float32),
        "codeword": sums["codeword"],
        "distance_min": sums["distance_min"].astype(np.float32),
        "magnitude_mean": (sums["magnitude_sum"] / safe).astype(np.float32),
        "bit_means": bit_means.astype(np.float32),
        "bit_sums": bit_sums.astype(np.float32),
        "moments": np.stack([m_zz, m_yy, m_xx, m_zy, m_zx, m_yx], axis=1).astype(
            np.float32
        ),
    }
    if collect_weighted_centroids:
        out["bit_w_coord_sums"] = sums["bits_zyx"].astype(np.float32)
    return out


def inertia_tensor_eigvals(moments: np.ndarray, area: np.ndarray) -> np.ndarray:
    """skimage-compatible inertia tensor eigenvalues (descending) from the
    central second moments."""
    m_zz, m_yy, m_xx, m_zy, m_zx, m_yx = (moments[:, i] for i in range(6))
    n = moments.shape[0]
    T = np.zeros((n, 3, 3), np.float64)
    T[:, 0, 0] = m_yy + m_xx
    T[:, 1, 1] = m_zz + m_xx
    T[:, 2, 2] = m_zz + m_yy
    T[:, 0, 1] = T[:, 1, 0] = -m_zy
    T[:, 0, 2] = T[:, 2, 0] = -m_zx
    T[:, 1, 2] = T[:, 2, 1] = -m_yx
    eig = np.linalg.eigvalsh(T)[:, ::-1]
    return eig.astype(np.float32)
