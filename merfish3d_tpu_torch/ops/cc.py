"""Region properties of decoded components (counterpart of the numpy
half of ``merfish3d_tpu/ops/cc.py``: :class:`SparseIntensity`,
:func:`component_stats_host`, :func:`inertia_tensor_eigvals`).

Copied rather than imported: the JAX package cannot be imported without
JAX. On host arrays it is numpy, paired with the native union-find
labelling in :mod:`merfish3d_tpu_torch.native`; on tensors the sums come
from :mod:`.components` on the tensors' device, and numpy only derives
the statistics from the rows that come down.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .components import GEOMETRY_COLUMNS, component_sums


class SparseIntensity:
    """Foreground-only per-bit intensities: sorted linear indices plus
    ``(bits, n_fg)`` values, gathered on the device right after the
    decode so only foreground values cross to the host. Callers may
    gather any subset of the stored foreground."""

    def __init__(self, fg_lin: np.ndarray, values: np.ndarray):
        order = np.argsort(fg_lin, kind="stable")
        self._lin = fg_lin[order]
        self._vals = values[:, order]
        self.nbits = int(values.shape[0])

    def __call__(self, lin: np.ndarray) -> np.ndarray:
        if lin.size == 0:
            return np.zeros((self.nbits, 0), np.float32)
        pos = np.searchsorted(self._lin, lin)
        return self._vals[:, pos].astype(np.float32)


def component_stats_host(
    decoded,  # (Z, Y, X) int array, or int16 tensor
    labels,  # (Z, Y, X) int64 root indices (-1 bg) or sparse (lin, roots)
    distance,
    magnitude,
    scaled,  # (bits, Z, Y, X) array OR callable lin -> (bits, n_fg), or tensor
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

    Host arrays take the numpy sums (``np.bincount``). Tensors (the
    labels of :func:`..ops.components.label_components`, float16 distance
    and magnitude, the (bits, Z, Y, X) intensity tensor) take
    :func:`..ops.components.component_sums` on their device, the same sums
    bit for bit, and only the window's rows come to the host."""
    if isinstance(decoded, torch.Tensor):
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

    shape = decoded.shape
    ny, nx = shape[1], shape[2]
    if isinstance(labels, tuple):
        lin = np.asarray(labels[0])
        roots_fg = np.asarray(labels[1])
    else:
        flat_labels = np.asarray(labels).ravel()
        lin = np.flatnonzero(flat_labels >= 0)
        roots_fg = None
    if lin.size == 0:
        bits = scaled.nbits if callable(scaled) else scaled.shape[0]
        empty = np.zeros(0, np.float32)
        return {
            "valid": np.zeros(0, bool),
            "area": empty,
            "centroid_zyx": np.zeros((0, 3), np.float32),
            "codeword": np.zeros(0, np.int32),
            "distance_min": empty,
            "magnitude_mean": empty,
            "bit_means": np.zeros((bits, 0), np.float32),
            "bit_sums": np.zeros((bits, 0), np.float32),
            "bit_w_coord_sums": np.zeros((bits, 0, 3), np.float32),
            "moments": np.zeros((0, 6), np.float32),
        }
    roots = roots_fg if roots_fg is not None else flat_labels[lin]
    uniq, first_idx, idx = np.unique(roots, return_index=True, return_inverse=True)
    n = len(uniq)
    z = (lin // (ny * nx)).astype(np.float64)
    rem = lin % (ny * nx)
    y = (rem // nx).astype(np.float64)
    x = (rem % nx).astype(np.float64)

    def wsum(v):
        return np.bincount(idx, weights=v, minlength=n)

    dist_fg = np.asarray(distance).ravel()[lin].astype(np.float64)
    order = np.lexsort((dist_fg, idx))
    first_of = np.searchsorted(idx[order], np.arange(n))
    sums = {
        "area": wsum(np.ones_like(z)),
        "z": wsum(z), "y": wsum(y), "x": wsum(x),
        "zz": wsum(z * z), "yy": wsum(y * y), "xx": wsum(x * x),
        "zy": wsum(z * y), "zx": wsum(z * x), "yx": wsum(y * x),
        "magnitude_sum": wsum(np.asarray(magnitude).ravel()[lin].astype(np.float64)),
        "distance_min": dist_fg[order][first_of],
        "codeword": np.asarray(decoded).ravel()[lin[first_idx]].astype(np.int32),
    }

    if callable(scaled):
        bits = scaled.nbits
        bit_fg = np.asarray(scaled(lin), np.float64)
    else:
        bits = scaled.shape[0]
        # gather the foreground first, widen second
        bit_fg = np.stack(
            [np.asarray(scaled[b]).ravel()[lin].astype(np.float64) for b in range(bits)]
        )
    sums["bits"] = np.stack([wsum(bit_fg[b]) for b in range(bits)])
    if collect_weighted_centroids:
        sums["bits_zyx"] = np.stack(
            [np.stack([wsum(bit_fg[b] * c) for c in (z, y, x)], axis=-1) for b in range(bits)]
        )
    if size_window is not None:
        keep = (sums["area"] >= size_window[0]) & (sums["area"] <= size_window[1])
        sums = {k: v[..., keep, :] if k == "bits_zyx" else v[..., keep] for k, v in sums.items()}
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
