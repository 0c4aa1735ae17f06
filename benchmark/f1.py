"""F1 of decoded spots against the generator's ground truth: greedy
closest-first one-to-one same-gene matching within a radius, through
per-gene KD-trees (a frozen copy of the program's ``match_spots_f1``,
with the greedy matching in numpy). Also the row matching that compares
two decoded tables."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def greedy_match(src: np.ndarray, dst: np.ndarray, dist: np.ndarray) -> list[tuple[int, int]]:
    """Pairs accepted when taken in ascending distance (ties by index) and
    kept only where neither end is taken yet."""
    used_s, used_d = set(), set()
    pairs = []
    for i in np.lexsort((np.arange(len(dist)), dist)):
        s, d = int(src[i]), int(dst[i])
        if s in used_s or d in used_d:
            continue
        used_s.add(s)
        used_d.add(d)
        pairs.append((s, d))
    return pairs


def matched_pairs(genes_a, pts_a, genes_b, pts_b, radius: float) -> list[tuple[int, int]]:
    """Same-gene one-to-one matches ``(row of a, row of b)`` within
    ``radius`` between two point sets (``pts`` (n, 3))."""
    genes_a = np.asarray(genes_a).astype(str)
    genes_b = np.asarray(genes_b).astype(str)
    pairs = []
    for gene in sorted(set(genes_a) & set(genes_b)):
        rows_a = np.flatnonzero(genes_a == gene)
        rows_b = np.flatnonzero(genes_b == gene)
        k = min(4, len(rows_b))
        dists, idxs = cKDTree(pts_b[rows_b]).query(pts_a[rows_a], k=k)
        dists = np.asarray(dists).reshape(-1)
        idxs = np.asarray(idxs).reshape(-1)
        src = np.repeat(np.arange(len(rows_a)), k)
        ok = np.isfinite(dists) & (dists <= radius)
        pairs += [(int(rows_a[s]), int(rows_b[d])) for s, d in greedy_match(src[ok], idxs[ok], dists[ok])]
    return pairs


def f1_counts(decoded: dict, ground_truth: dict, radius_um: float) -> tuple[int, int, int]:
    """(true positives, decoded, ground truth) at ``radius_um``."""
    coords = ("global_z", "global_y", "global_x")
    n_dec = len(decoded["gene_id"]) if decoded else 0
    n_gt = len(ground_truth["gene_id"])
    if n_dec == 0:
        return 0, 0, n_gt
    pts_d = np.stack([np.asarray(decoded[c], float) for c in coords], axis=1)
    pts_g = np.stack([np.asarray(ground_truth[c], float) for c in coords], axis=1)
    return len(matched_pairs(decoded["gene_id"], pts_d, ground_truth["gene_id"], pts_g, radius_um)), n_dec, n_gt


def f1_score(tp: int, n_dec: int, n_gt: int) -> float:
    precision = tp / n_dec if n_dec else 0.0
    recall = tp / n_gt if n_gt else 0.0
    return 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
