"""Per-voxel nearest-codeword decoding in plain torch (frozen copy of the
program's plain decode and of its lowpass + decode pipeline).

Traces and codewords are both L2-normalized, so the nearest codeword is
``argmax(t · c)`` with ``dist = sqrt(2 - 2 max(t · c))``. Outputs are host
numpy: decoded int16 (-1 unassigned), magnitude and distance float16, and
the scaled traces (dense float16, or gathered at the decoded voxels).
"""

from __future__ import annotations

import numpy as np
import torch

from .cc import SparseIntensity
from .filters import gaussian_lowpass
from .precision import q

Z_CHUNK = 4


def normalize_codebook(codebook_matrix: np.ndarray) -> np.ndarray:
    cb = np.asarray(codebook_matrix, dtype=np.float32)
    norm = np.linalg.norm(cb, axis=1, keepdims=True)
    return cb / np.maximum(norm, 1e-12)


def caller_thresholds(on_bits_median: int) -> tuple[float, float]:
    """(pixel assignment threshold, transcript distance threshold) from the
    median on-bit count B."""
    b = float(on_bits_median)
    pixel = np.sqrt(2.0 - 2.0 * (b - 2.0) / np.sqrt(b * (b - 2.0)))
    transcript = np.sqrt(2.0 - 2.0 * b / np.sqrt(b * (b + 2.0)))
    return float(pixel), float(transcript)


def _decode_chunk(traces, codebook_t, background, normalization):
    scaled = q(((traces - background[:, None]) / normalization[:, None]).clamp(0.0, 1.0))
    mag = q(torch.sqrt(torch.sum(scaled * scaled, dim=0)))
    unit = q(scaled / torch.clamp(mag, min=1e-12)[None, :])
    sims = q(codebook_t.T @ unit)
    max_sim, best = torch.max(sims, dim=0)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * max_sim, min=0.0))
    return best.to(torch.int32), dist, mag, scaled


def _decode(vol, codebook_matrix, background, normalization, *, magnitude_threshold,
            distance_threshold, keep_scaled):
    """Decode a (bits, Z, Y, X) float32 device volume in z-chunks."""
    dev = vol.device
    cb_t = torch.as_tensor(normalize_codebook(codebook_matrix).T.copy(), device=dev)
    bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
    norm = torch.as_tensor(np.asarray(normalization, np.float32), device=dev)
    bits, nz, ny, nx = vol.shape
    lo, hi = magnitude_threshold
    decoded = np.empty((nz, ny, nx), np.int16)
    mag = np.empty((nz, ny, nx), np.float16)
    dist = np.empty((nz, ny, nx), np.float16)
    scaled = torch.empty(vol.shape, dtype=torch.float32, device=dev) if keep_scaled else None
    for z0 in range(0, nz, Z_CHUNK):
        z1 = min(z0 + Z_CHUNK, nz)
        best, di, m, sc = _decode_chunk(vol[:, z0:z1].reshape(bits, -1), cb_t, bg, norm)
        assigned = (di <= distance_threshold) & (m >= lo) & (m <= hi)
        decoded[z0:z1] = torch.where(assigned, best, -1).to(torch.int16).reshape(z1 - z0, ny, nx).cpu().numpy()
        mag[z0:z1] = m.to(torch.float16).reshape(z1 - z0, ny, nx).cpu().numpy()
        dist[z0:z1] = di.to(torch.float16).reshape(z1 - z0, ny, nx).cpu().numpy()
        if keep_scaled:
            scaled[:, z0:z1] = sc.reshape(bits, z1 - z0, ny, nx)
    return decoded, mag, dist, scaled


def gather_values(volume: torch.Tensor, lin: np.ndarray) -> np.ndarray:
    flat = volume.reshape(volume.shape[0], -1)
    idx = torch.as_tensor(lin, dtype=torch.int64, device=volume.device)
    return flat.index_select(1, idx).to(torch.float32).cpu().numpy()


def decode_lowpassed(lp, codebook_matrix, background, normalization, *, magnitude_threshold,
                     distance_threshold):
    """Decode an already lowpassed stack (the optimization passes)."""
    decoded, mag, dist, _ = _decode(
        lp, codebook_matrix, background, normalization, magnitude_threshold=magnitude_threshold,
        distance_threshold=distance_threshold, keep_scaled=False,
    )
    return decoded, mag, dist


def lowpass_decode_volume(vol, codebook_matrix, background, normalization, *, sigma,
                          magnitude_threshold, distance_threshold):
    """Lowpass then decode (the final decode); the scaled traces come back
    gathered at the decoded voxels, float16-rounded as the program hands
    them over."""
    lp = q(gaussian_lowpass(vol, sigma=tuple(float(s) for s in sigma)))
    decoded, mag, dist, scaled = _decode(
        lp, codebook_matrix, background, normalization, magnitude_threshold=magnitude_threshold,
        distance_threshold=distance_threshold, keep_scaled=True,
    )
    del lp
    lin = np.flatnonzero(decoded >= 0)
    values = gather_values(scaled.to(torch.float16), lin)
    return decoded, mag, dist, SparseIntensity(lin, values)
