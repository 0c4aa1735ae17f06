"""Host-side region properties of decoded components (counterpart of the
numpy half of ``merfish3d_tpu/ops/cc.py``: :class:`SparseIntensity`,
:func:`component_stats_host`, :func:`inertia_tensor_eigvals`).

Copied rather than imported: the JAX package cannot be imported without
JAX. Pure numpy; the decoder pairs it with the scipy
labelling in :mod:`.labels`.
"""

from __future__ import annotations

import numpy as np


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
    decoded: np.ndarray,  # (Z, Y, X) int
    labels,  # (Z, Y, X) int64 root indices (-1 bg) or sparse (lin, roots)
    distance: np.ndarray,
    magnitude: np.ndarray,
    scaled,  # (bits, Z, Y, X) array OR callable lin -> (bits, n_fg)
    *,
    collect_weighted_centroids: bool = False,
) -> dict:
    """Regionprops over the assigned voxels only (numpy bincount): area,
    centroid, codeword, min distance, mean magnitude, per-bit sums and
    means and central second moments per component; with
    ``collect_weighted_centroids`` also ``bit_w_coord_sums`` (bits, n, 3),
    each bit's intensity-weighted z, y, x sums (the chromatic estimator's
    per-bit centroids)."""
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

    area = wsum(np.ones_like(z))
    safe = np.maximum(area, 1.0)
    cz, cy, cx = wsum(z) / safe, wsum(y) / safe, wsum(x) / safe
    dist_fg = np.asarray(distance).ravel()[lin].astype(np.float64)
    order = np.lexsort((dist_fg, idx))
    first_of = np.searchsorted(idx[order], np.arange(n))
    dist_min = dist_fg[order][first_of]
    mag_mean = wsum(np.asarray(magnitude).ravel()[lin].astype(np.float64)) / safe
    codeword = np.asarray(decoded).ravel()[lin[first_idx]].astype(np.int32)

    if callable(scaled):
        bits = scaled.nbits
        bit_fg = np.asarray(scaled(lin), np.float64)
    else:
        bits = scaled.shape[0]
        # gather the foreground first, widen second
        bit_fg = np.stack(
            [np.asarray(scaled[b]).ravel()[lin].astype(np.float64) for b in range(bits)]
        )
    bit_sums = np.stack([wsum(bit_fg[b]) for b in range(bits)])
    bit_means = bit_sums / safe[None, :]

    m_zz = wsum(z * z) / safe - cz * cz
    m_yy = wsum(y * y) / safe - cy * cy
    m_xx = wsum(x * x) / safe - cx * cx
    m_zy = wsum(z * y) / safe - cz * cy
    m_zx = wsum(z * x) / safe - cz * cx
    m_yx = wsum(y * x) / safe - cy * cx

    out = {
        "valid": np.ones(n, bool),
        "area": area.astype(np.float32),
        "centroid_zyx": np.stack([cz, cy, cx], axis=1).astype(np.float32),
        "codeword": codeword,
        "distance_min": dist_min.astype(np.float32),
        "magnitude_mean": mag_mean.astype(np.float32),
        "bit_means": bit_means.astype(np.float32),
        "bit_sums": bit_sums.astype(np.float32),
        "moments": np.stack([m_zz, m_yy, m_xx, m_zy, m_zx, m_yx], axis=1).astype(
            np.float32
        ),
    }
    if collect_weighted_centroids:
        out["bit_w_coord_sums"] = np.stack(
            [np.stack([wsum(bit_fg[b] * c) for c in (z, y, x)], axis=-1) for b in range(bits)]
        ).astype(np.float32)
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
