"""Blank-fraction transcript filter (counterpart of ``filter_blank_fraction``
and its helpers in ``merfish3d_tpu/pipeline/filtering.py``).

Tables are ``dict[str, np.ndarray]`` of equal-length columns, in the
reference's column names and order; the helpers below take rows out of
and join such tables.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def table_len(table: dict) -> int:
    return len(next(iter(table.values()))) if table else 0


def select_rows(table: dict, rows) -> dict:
    """Rows of every column by boolean mask or index array."""
    return {k: np.asarray(v)[rows] for k, v in table.items()}


def concat_tables(tables: list[dict]) -> dict:
    """Row-wise join of tables with the same columns (empty tables skip)."""
    tables = [t for t in tables if table_len(t)]
    if not tables:
        return {}
    return {k: np.concatenate([np.asarray(t[k]) for t in tables]) for k in tables[0]}


def is_blank(gene_ids) -> np.ndarray:
    return np.char.startswith(np.char.lower(np.asarray(gene_ids).astype(str)), "blank")


def _quantile_edges(values: np.ndarray, n: int = 11) -> np.ndarray:
    edges = np.unique(np.quantile(values, np.linspace(0.0, 1.0, n)))
    edges = edges[np.isfinite(edges)]
    if edges.size < 2 or np.allclose(edges[0], edges[-1]):
        center = float(np.mean(values)) if edges.size else 0.0
        edges = np.array([center - 0.5, center + 0.5])
    edges[0] = min(edges[0], float(np.min(values)))
    edges[-1] = max(edges[-1], float(np.max(values)))
    edges[-1] = np.nextafter(edges[-1], np.inf)
    return edges


def _voxel_count_edges(values: np.ndarray) -> np.ndarray:
    """Integer-aware edges for area."""
    min_v = int(np.floor(np.min(values)))
    max_v = int(np.ceil(np.max(values)))
    if max_v - min_v + 1 <= 10:
        edges = np.arange(min_v - 0.5, max_v + 1.5, 1.0)
    else:
        quantiles = np.quantile(values, np.linspace(0.0, 1.0, 11))
        qe = np.unique(np.floor(quantiles).astype(float))
        if qe.size == 0:
            qe = np.array([float(min_v), float(max_v + 1)])
        if qe[0] > min_v:
            qe = np.insert(qe, 0, float(min_v))
        if qe[-1] <= max_v:
            qe = np.append(qe, float(max_v + 1))
        edges = qe - 0.5
    edges = np.unique(edges[np.isfinite(edges)])
    if edges.size < 2 or np.allclose(edges[0], edges[-1]):
        center = float(np.mean(values))
        edges = np.array([center - 0.5, center + 0.5])
    edges[0] = min(edges[0], float(np.min(values)))
    edges[-1] = max(edges[-1], float(np.max(values)))
    edges[-1] = np.nextafter(edges[-1], np.inf)
    return edges


def _distance_edges(values: np.ndarray) -> np.ndarray:
    edges = np.unique(np.linspace(float(np.min(values)), float(np.max(values)), 11))
    edges = edges[np.isfinite(edges)]
    if edges.size < 2 or np.allclose(edges[0], edges[-1]):
        center = float(np.mean(values))
        edges = np.array([center - 0.5, center + 0.5])
    edges[0] = min(edges[0], float(np.min(values)))
    edges[-1] = max(edges[-1], float(np.max(values)))
    edges[-1] = np.nextafter(edges[-1], np.inf)
    return edges


def filter_blank_fraction(
    table: dict,
    *,
    n_blank_codewords: int,
    n_total_codewords: int,
    target_misid_rate: float = 0.05,
    diagnostics_out: Optional[dict] = None,
) -> dict:
    """3D blank-fraction histogram filter over (magnitude_mean, area,
    distance_min): quantile-derived bin edges, per-bin blank fraction,
    threshold sweep to reach the target gross misidentification rate
    ``(blank_kept/blank_codewords)/(total_kept/total_codewords)``, else
    the best rate reached. Returns the kept rows with the added columns
    ``blank_fraction_bin``, ``blank_fraction``, ``blank_fraction_keep``
    and ``cell_id`` (-1)."""
    diagnostics = {
        "target_gross_misid_rate": float(target_misid_rate),
        "chosen_threshold": np.nan,
        "achieved_gross_misid_rate": np.inf,
        "target_reached": False,
    }
    n_rows = table_len(table)
    out = dict(table)
    out["blank_fraction_bin"] = np.full(n_rows, -1, np.int64)
    out["blank_fraction"] = np.full(n_rows, np.nan)
    out["blank_fraction_keep"] = np.zeros(n_rows, bool)
    if n_rows == 0:
        diagnostics["reason"] = "no_transcripts"
    else:
        feats = np.column_stack(
            [np.asarray(table[k], float) for k in ("magnitude_mean", "area", "distance_min")]
        )
        valid = np.all(np.isfinite(feats), axis=1)
        blank = is_blank(table["gene_id"])
        if not valid.any():
            diagnostics["reason"] = "no_valid_features"
        elif n_blank_codewords <= 0:
            out["blank_fraction_keep"] = valid.copy()
            diagnostics["reason"] = "no_blank_barcodes"
        elif not blank[valid].any():
            out["blank_fraction_keep"] = valid.copy()
            diagnostics["reason"] = "no_blank_transcripts"
        else:
            v = feats[valid]
            i_edges = _quantile_edges(v[:, 0])
            n_edges = _voxel_count_edges(v[:, 1])
            d_edges = _distance_edges(v[:, 2])
            bins = np.column_stack(
                [
                    np.searchsorted(i_edges, feats[:, 0], side="right") - 1,
                    np.searchsorted(n_edges, feats[:, 1], side="right") - 1,
                    np.searchsorted(d_edges, feats[:, 2], side="right") - 1,
                ]
            )
            shape = (len(i_edges) - 1, len(n_edges) - 1, len(d_edges) - 1)
            in_range = (
                valid
                & (bins >= 0).all(axis=1)
                & (bins[:, 0] < shape[0])
                & (bins[:, 1] < shape[1])
                & (bins[:, 2] < shape[2])
            )
            if not in_range.any():
                diagnostics["reason"] = "no_transcripts_in_histogram_range"
            else:
                idx = bins[in_range]
                all_hist = np.zeros(shape, np.int64)
                np.add.at(all_hist, tuple(idx.T), 1)
                blank_hist = np.zeros(shape, np.int64)
                bidx = bins[in_range & blank]
                if bidx.size:
                    np.add.at(blank_hist, tuple(bidx.T), 1)
                bf_hist = np.full(shape, np.nan, np.float64)
                nonempty = all_hist > 0
                bf_hist[nonempty] = blank_hist[nonempty] / all_hist[nonempty]
                flat = np.ravel_multi_index(tuple(idx.T), shape)
                bf = np.full(n_rows, np.nan)
                bf[in_range] = bf_hist.ravel()[flat]
                bins_safe = np.minimum(bins.clip(0), np.asarray(shape) - 1)
                out["blank_fraction_bin"] = np.where(
                    in_range, np.ravel_multi_index(tuple(bins_safe.T), shape), -1
                )
                out["blank_fraction"] = bf
                chosen, achieved, reached = np.nan, np.inf, False
                keep_mask = np.zeros(n_rows, bool)
                sweep = []
                for thr in np.unique(bf_hist[nonempty]):
                    km = in_range & (bf <= float(thr))
                    if km.any():
                        rate = (int((km & blank).sum()) / n_blank_codewords) / (
                            int(km.sum()) / n_total_codewords
                        )
                    else:
                        rate = np.inf
                    sweep.append((float(thr), float(rate), int(km.sum())))
                    if rate <= target_misid_rate:
                        chosen, achieved, keep_mask, reached = (
                            float(thr), float(rate), km.copy(), True,
                        )
                if not reached and sweep:
                    best = min(range(len(sweep)), key=lambda i: sweep[i][1])
                    chosen, achieved = sweep[best][0], sweep[best][1]
                    keep_mask = in_range & (bf <= chosen)
                out["blank_fraction_keep"] = keep_mask
                diagnostics.update(
                    {
                        "chosen_threshold": chosen,
                        "achieved_gross_misid_rate": achieved,
                        "target_reached": reached,
                        "threshold_sweep": np.asarray(sweep, np.float64).reshape(-1, 3),
                    }
                )
    if diagnostics_out is not None:
        diagnostics_out.update(diagnostics)
    filtered = select_rows(out, out["blank_fraction_keep"])
    filtered["cell_id"] = np.full(table_len(filtered), -1, np.int64)
    return filtered
