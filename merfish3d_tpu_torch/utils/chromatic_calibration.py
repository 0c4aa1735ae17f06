"""Bead-based chromatic affine calibration (counterpart of
``merfish3d_tpu/utils/chromatic_calibration.py``): multi-channel bead
stacks → RLGC deconvolution with vectorial PSFs → bead detection →
mutual nearest-neighbour matching between channels → a robust full 3-D
affine per channel toward the reference (lowest) wavelength.

Detection runs on the volume's device: the spot predictor, the robust
intensity floor (median + k·MAD) and the 3x3x3 local maxima (a max pool,
which equals ``scipy.ndimage.maximum_filter``'s reflect mode: a reflected
neighbour is already in the window); the peaks' intensity-weighted
refinement and everything after it run on the host in float64, as the
reference's. Tables are dicts of columns (no pandas).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree

from ..models.psf import make_channel_psfs
from ..models.ufish import DoGSpotPredictor, get_predictor, median_last
from ..ops.device import as_device_tensor
from ..ops.rlgc import chunked_rlgc, rlgc


def detect_beads(
    volume,
    *,
    threshold: float = 0.5,
    max_beads: int = 5000,
    intensity_mad_multiplier: float = 10.0,
    predictor=None,
    device=None,
) -> np.ndarray:
    """Bead centroids (z, y, x in px, float64): local maxima of the raw
    intensity where the spot probability exceeds ``threshold`` and the
    intensity exceeds median + k·1.4826·MAD, each refined to the
    intensity-weighted centroid of its 3x3x3 neighbourhood. ``predictor``
    is a spot predictor module (default: the DoG predictor); the volume
    stays on its device, or goes to ``device`` (the card by default)."""
    vol = as_device_tensor(volume, device).to(torch.float32)
    if predictor is None:
        predictor = DoGSpotPredictor()
    with torch.no_grad():
        prob = predictor(vol[None])[0].to(vol.device)
    med = float(median_last(vol.reshape(-1)))
    mad = float(median_last((vol - med).abs().reshape(-1))) * 1.4826
    intensity_floor = med + intensity_mad_multiplier * max(mad, 1e-6)
    # local maxima on the raw intensity (the sigmoid probability saturates
    # into plateaus over bright beads, making every plateau voxel a "max")
    local_max = F.max_pool3d(vol[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    peaks = (vol == local_max) & (prob > threshold) & (vol > intensity_floor)
    zs, ys, xs = (c.cpu().numpy() for c in torch.nonzero(peaks, as_tuple=True))
    if len(zs) > max_beads:
        order = np.argsort(prob[zs, ys, xs].cpu().numpy())[::-1][:max_beads]
        zs, ys, xs = zs[order], ys[order], xs[order]
    host = vol.cpu().numpy()
    centers = np.empty((len(zs), 3), np.float64)
    for i, (z, y, x) in enumerate(zip(zs, ys, xs)):
        zl, zh = max(0, z - 1), min(host.shape[0], z + 2)
        yl, yh = max(0, y - 1), min(host.shape[1], y + 2)
        xl, xh = max(0, x - 1), min(host.shape[2], x + 2)
        roi = host[zl:zh, yl:yh, xl:xh].astype(np.float64)
        w = roi.sum()
        if w <= 0:
            centers[i] = (z, y, x)
            continue
        zz, yy, xx = np.meshgrid(np.arange(zl, zh), np.arange(yl, yh), np.arange(xl, xh), indexing="ij")
        centers[i] = ((roi * zz).sum() / w, (roi * yy).sum() / w, (roi * xx).sum() / w)
    return centers


def mutual_nearest_neighbors(
    source_pts: np.ndarray, target_pts: np.ndarray, max_distance: float
) -> tuple[np.ndarray, np.ndarray]:
    """Mutual nearest-neighbour correspondences within ``max_distance``."""
    if len(source_pts) == 0 or len(target_pts) == 0:
        return np.empty((0, 3)), np.empty((0, 3))
    d_st, j = cKDTree(target_pts).query(source_pts)
    _, i = cKDTree(source_pts).query(target_pts)
    keep = [(s, t) for s, (t, d) in enumerate(zip(j, d_st)) if d <= max_distance and i[t] == s]
    if not keep:
        return np.empty((0, 3)), np.empty((0, 3))
    s_idx, t_idx = zip(*keep)
    return source_pts[list(s_idx)], target_pts[list(t_idx)]


def fit_affine_source_to_reference(
    source_zyx_um: np.ndarray,
    target_zyx_um: np.ndarray,
    *,
    n_iterations: int = 5,
    residual_threshold_um: float = 0.5,
) -> tuple[np.ndarray, dict]:
    """Full 3-D affine least squares with iterative residual trimming."""
    src = np.asarray(source_zyx_um, np.float64)
    tgt = np.asarray(target_zyx_um, np.float64)
    keep = np.ones(len(src), bool)
    affine = np.eye(4)
    for _ in range(max(1, n_iterations)):
        if keep.sum() < 4:
            break
        homo = np.concatenate([src[keep], np.ones((keep.sum(), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(homo, tgt[keep], rcond=None)
        affine = np.eye(4)
        affine[:3, :4] = sol.T
        pred = (np.concatenate([src, np.ones((len(src), 1))], axis=1) @ affine.T)[:, :3]
        res = np.linalg.norm(pred - tgt, axis=1)
        new_keep = res <= residual_threshold_um
        if new_keep.sum() < 4 or np.array_equal(new_keep, keep):
            keep = new_keep if new_keep.sum() >= 4 else keep
            break
        keep = new_keep
    pred = (np.concatenate([src, np.ones((len(src), 1))], axis=1) @ affine.T)[:, :3]
    res = np.linalg.norm(pred - tgt, axis=1)
    diagnostics = {
        "n_pairs": int(len(src)),
        "n_inliers": int(keep.sum()),
        "median_residual_um": float(np.median(res[keep])) if keep.any() else np.nan,
    }
    return affine.astype(np.float32), diagnostics


def estimate_chromatic_affines(
    channel_volumes: Sequence,
    emission_wavelengths_um: Sequence[float],
    *,
    voxel_size_zyx_um,
    max_match_distance_um: float = 1.0,
    detection_threshold: float = 0.5,
    predictor=None,
    device=None,
) -> dict:
    """Detect beads per channel, match mutual nearest neighbours to the
    reference (lowest) wavelength and fit one affine per channel (source
    = channel, target = reference: the decode-warp convention). Returns
    the structured calibration payload."""
    spacing = np.asarray(voxel_size_zyx_um, np.float64)
    wavelengths = [float(w) for w in emission_wavelengths_um]
    ref_idx = int(np.argsort(wavelengths)[0])
    ref_wl = wavelengths[ref_idx]
    centers = [
        detect_beads(v, threshold=detection_threshold, predictor=predictor, device=device) * spacing
        for v in channel_volumes
    ]
    channels = {}
    for idx, wl in enumerate(wavelengths):
        key = f"wavelength_{wl:.6f}"
        entry = {"channel_index": idx, "channel_name": key, "wavelength_um": wl}
        if np.isclose(wl, ref_wl):
            channels[key] = {**entry, "reference_channel": True, "affine_zyx_um": np.eye(4).tolist(),
                             "status": "identity_reference",
                             "diagnostics": {"n_pairs": int(len(centers[idx]))}}
            continue
        src, tgt = mutual_nearest_neighbors(centers[idx], centers[ref_idx], max_match_distance_um)
        if len(src) < 4:
            channels[key] = {**entry, "reference_channel": False, "affine_zyx_um": np.eye(4).tolist(),
                             "status": "insufficient_matches", "diagnostics": {"n_pairs": int(len(src))}}
            continue
        affine, diag = fit_affine_source_to_reference(src, tgt)
        channels[key] = {**entry, "reference_channel": False,
                         "affine_zyx_um": np.asarray(affine, np.float64).tolist(),
                         "status": "affine_estimated", "diagnostics": diag}
    return {
        "reference_wavelength_um": ref_wl,
        "voxel_size_zyx_um": [float(v) for v in spacing],
        "estimator": "bead_mutual_nn_affine",
        "channels": channels,
    }


def run_chromatic_calibration(
    store,
    channel_volumes: Sequence,
    emission_wavelengths_um: Sequence[float],
    *,
    deconvolve: bool = True,
    detection_threshold: float = 0.5,
    psf_model: str = "vectorial",
    ufish_model: str = "simfish",
    ufish_checkpoint=None,
    voxel_size_zyx_um=None,
    device="cuda",
) -> dict:
    """The whole calibration on ``device``: optional RLGC of each bead
    stack (30 iterations, one PSF of ``psf_model`` per channel, vectorial
    by default), the affine estimate (bead detection by the U-FISH
    predictor when a checkpoint resolves, the DoG predictor otherwise),
    and the payload saved to ``store``. ``voxel_size_zyx_um`` overrides the
    store's when the beads were imaged at another spacing."""
    if voxel_size_zyx_um is None:
        voxel_size_zyx_um = store.voxel_size_zyx_um
    vols = [as_device_tensor(v, device).to(torch.float32) for v in channel_volumes]
    if deconvolve:
        psfs = make_channel_psfs(
            emission_wavelengths_um, na=store.na or 1.35, ri=store.ri or 1.4,
            voxel_size_zyx_um=voxel_size_zyx_um, shape_zyx=(15, 15, 15), model=psf_model,
        )
        vols = [rlgc(v, psf, max_iters=30, out="device") for v, psf in zip(vols, psfs)]
    calibration = estimate_chromatic_affines(
        vols, emission_wavelengths_um, voxel_size_zyx_um=voxel_size_zyx_um,
        detection_threshold=detection_threshold,
        predictor=get_predictor(ufish_model, ufish_checkpoint, device=device),
    )
    store.save_chromatic_affine_transforms_zyx_um(calibration)
    return calibration


def detect_bead_centroids(
    image_zyx,
    *,
    ufish_model=None,
    min_intensity_quantile: float = 0.5,
    max_beads=None,
    threshold: float = 0.5,
    device=None,
) -> dict:
    """One channel's bead table, columns z, y, x (px) and
    ``sum_decon_pixels`` (the 5x5x5 sum around each rounded centroid):
    rows below the sums' ``min_intensity_quantile`` dropped, the rest
    brightest first, at most ``max_beads``. ``ufish_model`` is a U-FISH
    checkpoint for the detection (DoG without one)."""
    predictor = None
    if ufish_model is not None:
        predictor = get_predictor("simfish", ufish_model, device=device or "cuda")
    centers = detect_beads(image_zyx, threshold=threshold, predictor=predictor, device=device,
                           max_beads=int(max_beads) if max_beads else 5000)
    vol = image_zyx.cpu().numpy() if isinstance(image_zyx, torch.Tensor) else np.asarray(image_zyx)
    vol = vol.astype(np.float32, copy=False)
    sums = []
    for z, y, x in np.round(centers).astype(int):
        zl, zh = max(0, z - 2), min(vol.shape[0], z + 3)
        yl, yh = max(0, y - 2), min(vol.shape[1], y + 3)
        xl, xh = max(0, x - 2), min(vol.shape[2], x + 3)
        sums.append(float(vol[zl:zh, yl:yh, xl:xh].sum()))
    sums = np.asarray(sums, np.float64)
    rows = np.arange(len(sums))
    if len(sums):
        rows = rows[sums >= np.quantile(sums, float(min_intensity_quantile))]
        rows = rows[np.argsort(-sums[rows], kind="stable")]
        if max_beads is not None:
            rows = rows[: int(max_beads)]
    table = {axis: centers[rows, i] for i, axis in enumerate("zyx")}
    table["sum_decon_pixels"] = sums[rows]
    return table


def deconvolve_channels(stack_czyx, psfs, *, crop_yx: int = 2048, max_iters: int = 30,
                        device=None) -> torch.Tensor:
    """RLGC (``chunked_rlgc``) of every channel of a (C, Z, Y, X) bead
    stack with one shared PSF or one per channel; the (C, Z, Y, X) result
    on the stack's device (the card for a host array)."""
    stack = as_device_tensor(stack_czyx, device)
    if len(psfs) not in (1, stack.shape[0]):
        raise ValueError("Provide either one shared PSF or one PSF per channel.")
    return torch.stack([
        chunked_rlgc(image.to(torch.float32), np.asarray(psfs[0] if len(psfs) == 1 else psfs[idx], np.float32),
                     crop_yx=crop_yx, max_iters=max_iters, out="device")
        for idx, image in enumerate(stack)
    ])


def generate_channel_psfs(
    *,
    num_z: int,
    voxel_size_zyx_um,
    wavelengths_um,
    na: float = 1.35,
    ri: float = 1.51,
    psf_nx: int = 51,
):
    """One vectorial PSF per channel, odd-sized, at most ``num_z`` planes."""
    nz = min(int(num_z) | 1, int(psf_nx) | 1)
    return list(make_channel_psfs(
        wavelengths_um, na=na, ri=ri, voxel_size_zyx_um=voxel_size_zyx_um,
        shape_zyx=(nz, int(psf_nx) | 1, int(psf_nx) | 1), model="vectorial",
    ))


def save_calibration_json(calibration: dict, output_path) -> None:
    """Write the calibration payload as indented JSON."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as handle:
        json.dump(calibration, handle, indent=2)
