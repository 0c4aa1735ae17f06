"""RNA-derived chromatic affine estimation (counterpart of
``merfish3d_tpu/pipeline/chromatic.py``), numpy on the port's
dict-of-columns tables.

Per-transcript, per-wavelength intensity-weighted on-bit centroids →
pairwise wavelength point sets (distance and weight percentile filters) →
a weighted RANSAC fit of the constrained chromatic model (z translation,
a shared y/x radial scale, y/x translations) → BFS composition across
the wavelength graph to the reference (lowest) wavelength → a
plausibility gate → the calibration saved to the store.

The arithmetic, the RANSAC generator (``np.random.default_rng(1729)``)
and the row order are the reference's: given the same table the
estimate, its statuses and its diagnostics are the reference's bit for
bit. Host-side: the point sets are small beside the images.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from .filtering import select_rows, table_len


@dataclass(frozen=True)
class ChromaticAffineEstimationConfig:
    min_pairs: int = 20
    distance_filter_min_pairs_multiplier: int = 4
    distance_filter_percentile: float = 25.0
    weight_filter_min_pairs_multiplier: int = 2
    weight_filter_percentile: float = 25.0
    residual_threshold_um: float = 0.35
    residual_threshold_z_spacing_fraction: float = 0.5
    z_limit_spacing_multiplier: float = 3.5
    lateral_scale_min: float = 0.85
    lateral_scale_max: float = 1.05
    lateral_shear_max: float = 0.08
    max_iterations: int = 6
    scale_regularization: float = 0.0
    robust_z_mad_multiplier: float = 3.0
    robust_z_mad_scale: float = 1.4826
    ransac_seed: int = 1729
    ransac_min_iterations: int = 64
    ransac_max_iterations: int = 512
    ransac_sample_size: int = 3
    centroid_z_support: int = 7
    centroid_weight_epsilon: float = 1e-6


def fit_affine_zyx_um(
    source_zyx_um: np.ndarray,
    target_zyx_um: np.ndarray,
    *,
    weights: np.ndarray | None = None,
    min_pairs: int,
    config: ChromaticAffineEstimationConfig,
    residual_threshold_um: float = 0.35,
) -> tuple[np.ndarray | None, dict]:
    """Constrained robust fit (z translation + shared y/x radial scale +
    y/x translations) with weighted-RANSAC seeding and iterative residual
    trimming. Decoded RNA spans the lateral field but a thin axial range,
    so a full 3-D affine would be ill-conditioned."""
    source = np.asarray(source_zyx_um, dtype=np.float64)
    target = np.asarray(target_zyx_um, dtype=np.float64)
    diagnostics: dict = {
        "input_pairs": int(source.shape[0]),
        "used_pairs": 0,
        "median_residual_um": np.nan,
        "p95_residual_um": np.nan,
        "source_extent_zyx_um": [0.0, 0.0, 0.0],
        "model": "z_translation_yx_radial_scale",
        "status": "insufficient_pairs",
    }
    if source.shape != target.shape or source.ndim != 2 or source.shape[1] != 3:
        diagnostics["status"] = "invalid_point_shape"
        return None, diagnostics
    if source.shape[0] < max(3, int(min_pairs)):
        return None, diagnostics
    if weights is None:
        weights_arr = np.ones(source.shape[0], dtype=np.float64)
    else:
        weights_arr = np.asarray(weights, dtype=np.float64)
        if weights_arr.shape != (source.shape[0],):
            diagnostics["status"] = "invalid_weight_shape"
            return None, diagnostics
        weights_arr = np.nan_to_num(weights_arr, nan=0.0, posinf=0.0, neginf=0.0)
        weights_arr = np.maximum(weights_arr, 0.0)
        if not np.any(weights_arr > 0):
            diagnostics["status"] = "invalid_weights"
            return None, diagnostics
        weights_arr = weights_arr / np.median(weights_arr[weights_arr > 0])
    diagnostics["source_extent_zyx_um"] = [float(v) for v in np.ptp(source, axis=0)]
    if np.linalg.matrix_rank(source[:, 1:3] - source[:, 1:3].mean(axis=0)) < 2:
        diagnostics["status"] = "insufficient_lateral_spatial_rank"
        return None, diagnostics

    def solve_yx(source_yx, target_yx, fit_weights):
        n = source_yx.shape[0]
        design_y = np.column_stack([source_yx[:, 0], np.ones(n), np.zeros(n)])
        design_x = np.column_stack([source_yx[:, 1], np.zeros(n), np.ones(n)])
        design = np.vstack([design_y, design_x])
        targets = np.concatenate([target_yx[:, 0], target_yx[:, 1]])
        sw = np.sqrt(np.maximum(np.concatenate([fit_weights, fit_weights]), 1e-12))
        wd = design * sw[:, None]
        wt = targets * sw
        if config.scale_regularization > 0:
            penalty = np.sqrt(float(config.scale_regularization))
            wd = np.vstack([wd, [[penalty, 0.0, 0.0]]])
            wt = np.concatenate([wt, [penalty]])
        sol, *_ = np.linalg.lstsq(wd, wt, rcond=None)
        return float(sol[0]), float(sol[1]), float(sol[2])

    def robust_z(z_offsets, fit_weights):
        finite = np.isfinite(z_offsets) & np.isfinite(fit_weights) & (fit_weights > 0)
        if not finite.any():
            return 0.0
        off = z_offsets[finite]
        w = fit_weights[finite]
        center = float(np.median(off))
        spread = float(np.median(np.abs(off - center)))
        if spread > 0:
            keep = np.abs(off - center) <= (
                float(config.robust_z_mad_multiplier) * float(config.robust_z_mad_scale) * spread
            )
            if keep.any():
                off, w = off[keep], w[keep]
        return float(np.average(off, weights=w))

    def build_affine(keep):
        scale, ty, tx = solve_yx(source[keep, 1:3], target[keep, 1:3], weights_arr[keep])
        tz = robust_z(target[keep, 0] - source[keep, 0], weights_arr[keep])
        affine = np.eye(4)
        affine[0, 3] = tz
        affine[1, 1] = scale
        affine[1, 3] = ty
        affine[2, 2] = scale
        affine[2, 3] = tx
        return affine

    def residuals_of(affine):
        homo = np.concatenate([source, np.ones((len(source), 1))], axis=1)
        pred = (homo @ affine.T)[:, :3]
        return np.linalg.norm(pred - target, axis=1)

    rng = np.random.default_rng(int(config.ransac_seed))
    keep = np.ones(source.shape[0], bool)
    best_keep, best_score, best_wscore, best_med = None, -1, -1.0, np.inf
    max_iters = min(int(config.ransac_max_iterations),
                    max(int(config.ransac_min_iterations), source.shape[0]))
    probs = weights_arr / np.sum(weights_arr)
    for _ in range(max_iters):
        idx = rng.choice(source.shape[0], size=int(config.ransac_sample_size), replace=False, p=probs)
        sample_keep_init = np.zeros(source.shape[0], bool)
        sample_keep_init[idx] = True
        try:
            affine = build_affine(sample_keep_init)
        except np.linalg.LinAlgError:
            continue
        res = residuals_of(affine)
        sample_keep = res <= float(residual_threshold_um)
        score = int(sample_keep.sum())
        if score < 3:
            continue
        wscore = float(weights_arr[sample_keep].sum())
        med = float(np.median(res[sample_keep]))
        if (
            score > best_score
            or (score == best_score and wscore > best_wscore)
            or (score == best_score and np.isclose(wscore, best_wscore) and med < best_med)
        ):
            best_keep, best_score, best_wscore, best_med = sample_keep, score, wscore, med
    if best_keep is not None:
        keep = best_keep

    affine = np.eye(4)
    for _ in range(max(1, int(config.max_iterations))):
        affine = build_affine(keep)
        res = residuals_of(affine)
        next_keep = res <= float(residual_threshold_um)
        if next_keep.sum() < max(3, int(min_pairs)):
            break
        if np.array_equal(next_keep, keep):
            keep = next_keep
            break
        keep = next_keep

    res = residuals_of(affine)
    kept = res[keep]
    if kept.size < max(3, int(min_pairs)):
        diagnostics["status"] = "too_few_inliers"
        diagnostics["used_pairs"] = int(kept.size)
        return None, diagnostics
    diagnostics.update({
        "used_pairs": int(kept.size),
        "median_residual_um": float(np.median(kept)),
        "p95_residual_um": float(np.percentile(kept, 95)),
        "status": "ok",
    })
    return affine.astype(np.float32), diagnostics


def _bit_wavelengths(store, n_merfish_bits: int) -> dict[int, float]:
    """1-based bit index → emission wavelength (µm)."""
    return {b + 1: float(store.bit_wavelengths_um[b][1]) for b in range(n_merfish_bits)}


def save_identity_chromatic_affines(store, n_merfish_bits: int) -> None:
    """Identity affines for every readout wavelength: the start of an
    iterative estimate."""
    wavelengths = sorted(set(_bit_wavelengths(store, n_merfish_bits).values()))
    reference_wavelength = wavelengths[0]
    channels = {}
    for index, wavelength in enumerate(wavelengths):
        key = f"wavelength_{wavelength:.6f}"
        channels[key] = {
            "channel_index": index,
            "channel_name": key,
            "wavelength_um": float(wavelength),
            "reference_channel": bool(np.isclose(wavelength, reference_wavelength)),
            "affine_zyx_um": np.eye(4, dtype=np.float32).tolist(),
            "diagnostics": {"paired_transcripts": 0, "pair_constraints": 0, "path_wavelengths_um": []},
            "status": "identity_reference"
            if np.isclose(wavelength, reference_wavelength)
            else "identity_initialization",
        }
    store.save_chromatic_affine_transforms_zyx_um({
        "reference_wavelength_um": float(reference_wavelength),
        "voxel_size_zyx_um": [float(v) for v in store.voxel_size_zyx_um],
        "estimator": "identity_initialization_for_iterative_decoding",
        "pair_constraints": 0,
        "contributing_transcripts": 0,
        "channels": channels,
    })


def _plausible(affine: np.ndarray, spacing, config) -> bool:
    """Cumulative-affine gate: lateral scale window, shear cap, axial
    translation limit."""
    lat = affine[1:3, 1:3]
    scales = np.asarray([lat[0, 0], lat[1, 1]])
    if np.any(scales < config.lateral_scale_min) or np.any(scales > config.lateral_scale_max):
        return False
    if max(abs(lat[0, 1]), abs(lat[1, 0])) > config.lateral_shear_max:
        return False
    if abs(affine[0, 3]) > config.z_limit_spacing_multiplier * float(spacing[0]):
        return False
    return True


def _named_gene(gene) -> bool:
    """A gene id that is present, not blank text and not a blank codeword."""
    if gene is None or (isinstance(gene, float) and np.isnan(gene)):
        return False
    text = str(gene)
    return text.strip() != "" and not text.lower().startswith("blank")


def estimate_chromatic_affines_from_barcodes(
    store,
    table: dict,
    *,
    n_merfish_bits: int,
    config: ChromaticAffineEstimationConfig = ChromaticAffineEstimationConfig(),
) -> None:
    """Estimate and save per-wavelength chromatic affines from the decoded
    table's sparse on-bit weighted centroids, ``bit{N:02d}_center_z/y/x``
    (px) and ``bit{N:02d}_intensity_sum``, with ``on_bit_1..4`` and
    ``gene_id``. The decode applied the previous calibration, so the fit
    measures the residual aberration and the saved affine composes it with
    the previous one."""
    min_pairs = int(config.min_pairs)
    if not table_len(table) or "gene_id" not in table:
        return
    table = select_rows(table, np.asarray([_named_gene(g) for g in table["gene_id"]], bool))
    if not table_len(table):
        return
    if "distance_min" in table:
        distances = np.asarray(table["distance_min"], dtype=np.float64)
        finite = np.isfinite(distances)
        required = int(config.distance_filter_min_pairs_multiplier) * min_pairs
        if int(finite.sum()) >= required:
            thr = float(np.nanpercentile(distances[finite], config.distance_filter_percentile))
            hc = finite & (distances <= thr)
            if int(hc.sum()) >= min_pairs:
                table = select_rows(table, hc)

    bit_wl = _bit_wavelengths(store, n_merfish_bits)
    unique_wl = sorted(set(bit_wl.values()))
    reference_wl = unique_wl[0]
    spacing = np.asarray(store.voxel_size_zyx_um, dtype=np.float64)

    previous_affines: dict[float, np.ndarray] = {}
    prev_cal = store.load_chromatic_affine_transforms_zyx_um() or {}
    for ch in prev_cal.get("channels", {}).values():
        if isinstance(ch, dict) and ch.get("wavelength_um") is not None and ch.get(
            "affine_zyx_um"
        ) is not None:
            previous_affines[float(ch["wavelength_um"])] = np.asarray(ch["affine_zyx_um"], dtype=np.float64)

    n = table_len(table)
    on_bit_cols = [c for c in ("on_bit_1", "on_bit_2", "on_bit_3", "on_bit_4") if c in table]
    centers_by_wl, weights_by_wl, valid_by_wl = {}, {}, {}
    for wl in unique_wl:
        wsum = np.zeros(n)
        csum = np.zeros((n, 3))
        for col in on_bit_cols:
            bits = np.asarray(table[col])
            for bi in np.unique(bits[np.isfinite(bits.astype(float))]).astype(int):
                if bit_wl.get(int(bi)) is None or not np.isclose(bit_wl[int(bi)], wl):
                    continue
                sel = bits == bi
                cz = table.get(f"bit{bi:02d}_center_z")
                cy = table.get(f"bit{bi:02d}_center_y")
                cx = table.get(f"bit{bi:02d}_center_x")
                w = table.get(f"bit{bi:02d}_intensity_sum")
                if cz is None or w is None:
                    continue
                pts = np.column_stack([np.asarray(c, float) for c in (cz, cy, cx)])
                wv = np.asarray(w, float)
                ok = sel & np.isfinite(pts).all(axis=1) & np.isfinite(wv) & (wv > 0)
                csum[ok] += pts[ok] * wv[ok, None]
                wsum[ok] += wv[ok]
        valid = wsum > 0
        centers = np.full((n, 3), np.nan)
        centers[valid] = csum[valid] / wsum[valid, None] * spacing
        centers_by_wl[wl] = centers
        weights_by_wl[wl] = wsum
        valid_by_wl[wl] = valid

    valid_count = np.zeros(n, np.int16)
    for v in valid_by_wl.values():
        valid_count += v.astype(np.int16)
    contributing = int(np.sum(valid_count >= 2))

    pair_points = {}
    for swl in unique_wl:
        for twl in unique_wl:
            if np.isclose(swl, twl):
                continue
            vp = valid_by_wl[swl] & valid_by_wl[twl]
            w = np.sqrt(weights_by_wl[swl][vp] * weights_by_wl[twl][vp])
            fin = np.isfinite(w) & (w > 0)
            src = centers_by_wl[swl][vp][fin]
            tgt = centers_by_wl[twl][vp][fin]
            w = w[fin]
            required_w = int(config.weight_filter_min_pairs_multiplier) * min_pairs
            if w.size >= required_w:
                min_w = np.percentile(w, config.weight_filter_percentile)
                strong = w >= min_w
                if int(strong.sum()) >= min_pairs:
                    src, tgt, w = src[strong], tgt[strong], w[strong]
            pair_points[(swl, twl)] = (src.astype(np.float32), tgt.astype(np.float32), w.astype(np.float32))

    residual_threshold = max(
        float(config.residual_threshold_um),
        float(config.residual_threshold_z_spacing_fraction) * float(spacing[0]),
    )
    edge_affines, edge_diags = {}, {}
    for pair, (src, tgt, w) in pair_points.items():
        if src.shape[0] < min_pairs:
            continue
        affine, diag = fit_affine_zyx_um(src, tgt, weights=w, min_pairs=min_pairs, config=config,
                                         residual_threshold_um=residual_threshold)
        diag["candidate_pairs"] = int(src.shape[0])
        edge_diags[pair] = diag
        if affine is not None:
            edge_affines[pair] = affine

    adjacency = {wl: [] for wl in unique_wl}
    for swl, twl in edge_affines:
        adjacency[swl].append(twl)

    affines = {reference_wl: np.eye(4, dtype=np.float32)}
    status = {reference_wl: "identity_reference"}
    diags = {
        wl: {"paired_transcripts": contributing, "pair_constraints": 0, "path_wavelengths_um": []}
        for wl in unique_wl
    }
    for wl in unique_wl:
        if np.isclose(wl, reference_wl):
            continue
        # BFS to the reference wavelength, composing edge affines
        queue = [(wl, [wl], np.eye(4, dtype=np.float32))]
        visited = {wl}
        found = False
        while queue and not found:
            current, path, composed = queue.pop(0)
            if np.isclose(current, reference_wl):
                prev = previous_affines.get(wl, np.eye(4))
                cumulative = (composed.astype(np.float64) @ prev).astype(np.float32)
                if not _plausible(cumulative, spacing, config):
                    status[wl] = "implausible_affine_rejected"
                    break
                affines[wl] = cumulative
                status[wl] = "affine_estimated"
                pair_count = 0
                path_fits = []
                for s, t in itertools.pairwise(path):
                    pair_count += pair_points[(s, t)][0].shape[0]
                    path_fits.append({
                        "source_wavelength_um": float(s),
                        "target_wavelength_um": float(t),
                        "fit": edge_diags[(s, t)],
                    })
                diags[wl] = {
                    "paired_transcripts": contributing,
                    "pair_constraints": int(pair_count),
                    "path_wavelengths_um": [float(v) for v in path],
                    "path_fits": path_fits,
                }
                found = True
                break
            for nxt in adjacency.get(current, []):
                if nxt in visited:
                    continue
                visited.add(nxt)
                queue.append((nxt, path + [nxt], edge_affines[(current, nxt)] @ composed))
        if wl not in affines:
            # keep the previous calibration when no new fit is available
            affines[wl] = previous_affines.get(wl, np.eye(4)).astype(np.float32)
            status.setdefault(wl, "no_path_to_reference")

    channels = {}
    total_constraints = 0
    for index, wl in enumerate(unique_wl):
        key = f"wavelength_{wl:.6f}"
        total_constraints += int(diags[wl].get("pair_constraints", 0))
        channels[key] = {
            "channel_index": index,
            "channel_name": key,
            "wavelength_um": float(wl),
            "reference_channel": bool(np.isclose(wl, reference_wl)),
            "affine_zyx_um": np.asarray(affines[wl], np.float64).tolist(),
            "diagnostics": diags[wl],
            "status": status.get(wl, "no_path_to_reference"),
        }
    store.save_chromatic_affine_transforms_zyx_um({
        "reference_wavelength_um": float(reference_wl),
        "voxel_size_zyx_um": [float(v) for v in spacing],
        "estimator": "rna_on_bit_weighted_centroids",
        "pair_constraints": total_constraints,
        "contributing_transcripts": contributing,
        "channels": channels,
    })
