"""Deformable residual flow estimation (counterpart of
``merfish3d_tpu/ops/flow.py``).

After the affine registration of a round, a residual flow field on a
regular lattice of patch centres is estimated as:

1. batched patch cross-correlation: every lattice patch of the reference
   and of the moving volume standardized (population std) and
   correlated through ``torch.fft``, ``config.batch_size`` patches at a
   time; the integer peak within a quarter patch a side, its peak ratio
   (best over second best outside a periodic Chebyshev neighbourhood)
   and sharpness (best over the mean |corr| of a ring around it), and a
   clipped 3-point parabolic sub-pixel refinement;
2. cleaning on the host (numpy): ratio, sharpness, magnitude and the
   deviation from the median of the surviving vectors;
3. a Jacobi relaxation on the device from the median: valid sites held
   to their measurement, invalid ones filled by the neighbour average,
   stopping at the reference's ``while_loop`` iteration;
4. the axial channel clipped to its median ± ``max_local_z_displacement_px``;
5. residual passes: the moving volume re-warped with the field so far
   (separable when the bounds admit it, else the gather), re-estimated,
   and the fields composed on the shared lattice.

The field is (3, fz, fy, fx), channels X, Y, Z, in reference px:
reference coordinate + flow = coordinate in the affine-registered moving
volume, lattice origin at the patch centres. The volumes stay on their
device; only lattice-sized arrays cross to the host.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import profiling
from ..utils.profiling import read_scalar, to_device, to_host
from .device import as_device_tensor
from .warp import (
    _affine_flow_warp_core,
    _flow_warp_separable_core,
    _map_coordinates,
    _separable_flow_bounds,
)


@dataclass(frozen=True)
class SofimaRegistrationConfig:
    """Deformable-registration settings, field for field the reference's.
    ``batch_size`` (patches a batched FFT) bounds memory and never
    changes a result."""

    residual_iterations: int = 2
    patch_size_zyx: tuple[int, int, int] = (10, 32, 32)
    minimum_patch_size_px: int = 4
    step_divisor: int = 2
    stride_zyx: Optional[tuple[int, int, int]] = None  # override patch // divisor
    peak_min_distance: int = 2
    peak_radius: int = 8
    batch_size: int = 512
    max_masked: float = 0.75
    min_peak_ratio: float = 1.2
    min_peak_sharpness: float = 1.2
    max_magnitude: float = 30.0
    max_deviation: float = 5.0
    max_local_z_displacement_px: float = 5.0
    normalization_epsilon: float = 1e-6
    relax_smoothness: float = 0.25
    relax_iterations: int = 200
    relax_tolerance: float = 1e-4

    def as_metadata(self) -> dict:
        """JSON-compatible settings."""
        md = asdict(self)
        md["patch_size_zyx"] = [int(v) for v in self.patch_size_zyx]
        if self.stride_zyx is not None:
            md["stride_zyx"] = [int(v) for v in self.stride_zyx]
        return md

    def resolve_patch_and_stride(
        self, shape_zyx: tuple[int, int, int]
    ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
        """The patch clipped to the volume with the minimum-size floor; the
        stride patch // step_divisor unless given, clipped to the patch."""
        patch = tuple(
            int(max(self.minimum_patch_size_px, min(s, p)))
            for s, p in zip(shape_zyx, self.patch_size_zyx)
        )
        if self.stride_zyx is not None:
            stride = tuple(int(max(1, min(st, p))) for st, p in zip(self.stride_zyx, patch))
        else:
            stride = tuple(max(1, p // max(1, int(self.step_divisor))) for p in patch)
        return patch, stride


def _lattice_starts(size: int, patch: int, stride: int) -> np.ndarray:
    n = max(1, (size - patch) // stride + 1)
    return np.arange(n) * stride


def _patch_xcorr_flow(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    *,
    patch_size: tuple[int, int, int],
    strides: tuple[int, int, int],
    batch_size: int = 512,
    peak_min_distance: int = 2,
    peak_radius: int = 8,
    max_masked: float = 0.75,
    normalization_epsilon: float = 1e-6,
):
    """Integer + sub-pixel flow of every lattice patch, with its peak ratio
    and sharpness: (flow_zyx (fz, fy, fx, 3), ratio, sharpness) as numpy,
    flow = −(peak + sub-pixel offset), the displacement of the moving
    content against the reference patch."""
    if peak_radius <= peak_min_distance:
        raise ValueError(
            f"peak_radius ({peak_radius}) must exceed peak_min_distance "
            f"({peak_min_distance}) so the sharpness ring is non-empty"
        )
    dev = fixed.device
    fixed = fixed.to(torch.float32)
    moving = moving.to(torch.float32)
    starts = [_lattice_starts(s, p, st) for s, p, st in zip(fixed.shape, patch_size, strides)]
    lattice_shape = tuple(len(s) for s in starts)
    n_patches = int(np.prod(lattice_shape))
    # (fz, fy, fx, pz, py, px) views of the lattice patches
    views = [
        v.unfold(0, patch_size[0], strides[0]).unfold(1, patch_size[1], strides[1])
        .unfold(2, patch_size[2], strides[2])[: lattice_shape[0], : lattice_shape[1], : lattice_shape[2]]
        for v in (fixed, moving)
    ]
    # patch-constant geometry: signed displacement of each bin, the
    # plausible-displacement mask (<= a quarter patch a side), coordinate
    # ramps for the periodic neighbourhoods
    signed = [to_device((np.fft.fftfreq(n) * n).astype(np.float32), dev) for n in patch_size]
    disp_ok = np.ones(patch_size, bool)
    for ax, n in enumerate(patch_size):
        shape = [1, 1, 1]
        shape[ax] = n
        disp_ok = disp_ok & (np.abs(np.fft.fftfreq(n) * n).reshape(shape) <= n // 4)
    disp_ok = to_device(disp_ok, dev)
    ramps = [
        torch.arange(n, device=dev).reshape([1] + [n if a == ax else 1 for a in range(3)])
        for ax, n in enumerate(patch_size)
    ]
    dims = (1, 2, 3)
    neg_inf = to_device(np.float32(-np.inf), dev)
    flows, ratios, sharps = [], [], []
    lin = torch.arange(n_patches, device=dev)
    for s in range(0, n_patches, max(1, int(batch_size))):
        ids = lin[s: s + batch_size]
        iz = ids // (lattice_shape[1] * lattice_shape[2])
        iy = (ids // lattice_shape[2]) % lattice_shape[1]
        ix = ids % lattice_shape[2]
        f, m = (v[iz, iy, ix] for v in views)
        masked_frac = ((f == 0.0) | (m == 0.0)).to(torch.float32).mean(dim=dims)
        f = f - f.mean(dim=dims, keepdim=True)
        m = m - m.mean(dim=dims, keepdim=True)
        f = f / (f.std(dim=dims, correction=0, keepdim=True) + normalization_epsilon)
        m = m / (m.std(dim=dims, correction=0, keepdim=True) + normalization_epsilon)
        spec = torch.fft.fftn(f, dim=dims) * torch.conj(torch.fft.fftn(m, dim=dims))
        corr = torch.fft.ifftn(spec, dim=dims).real
        del spec
        b = corr.shape[0]
        corr_m = torch.where(disp_ok, corr, neg_inf)
        flat = torch.argmax(corr_m.reshape(b, -1), dim=1)
        idx = torch.stack(torch.unravel_index(flat, tuple(patch_size)), dim=1)  # (b, 3)
        peak = torch.stack([signed[a][idx[:, a]] for a in range(3)], dim=1)
        best = corr_m.reshape(b, -1).gather(1, flat[:, None])[:, 0]
        neigh = torch.ones((b, *patch_size), dtype=torch.bool, device=dev)
        ring = torch.ones_like(neigh)
        for ax in range(3):
            n = patch_size[ax]
            d = torch.abs(ramps[ax] - idx[:, ax].reshape(b, 1, 1, 1))
            d = torch.minimum(d, n - d)
            neigh = neigh & (d <= peak_min_distance)
            ring = ring & (d <= peak_radius)
        second = torch.where(neigh, neg_inf, corr_m).amax(dim=dims)
        ratio = best / torch.clamp(second, min=1e-12)
        ratio = torch.where(second <= 0, torch.inf, ratio)
        # the exclusion covers the whole patch: no evidence the peak is distinct
        ratio = torch.where(torch.isneginf(second), 0.0, ratio)
        ratio = torch.where(masked_frac > max_masked, 0.0, ratio)
        ring_n = ring & ~neigh
        ring_sum = torch.where(ring_n, corr.abs(), 0.0).sum(dim=dims)
        ring_cnt = ring_n.to(torch.float32).sum(dim=dims)
        sharp = best / torch.clamp(ring_sum / torch.clamp(ring_cnt, min=1.0), min=1e-12)
        sharp = torch.where(ring_cnt == 0, 0.0, sharp)
        # 3-point parabola per axis, neighbours wrapped
        flat_corr = corr.reshape(b, -1)
        sub = []
        for ax in range(3):
            def get(off, ax=ax):
                lin_i = torch.zeros(b, dtype=torch.int64, device=dev)
                for a in range(3):
                    i = (idx[:, a] + (off if a == ax else 0)) % patch_size[a]
                    lin_i = lin_i * patch_size[a] + i
                return flat_corr.gather(1, lin_i[:, None])[:, 0]

            cm, c0, cp = get(-1), get(0), get(1)
            denom = cm - 2 * c0 + cp
            delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (cm - cp) / denom, 0.0)
            sub.append(torch.clamp(delta, -0.5, 0.5))
        flows.append(-(peak + torch.stack(sub, dim=1)))
        ratios.append(ratio)
        sharps.append(sharp)
    return (
        to_host(torch.cat(flows)).reshape(*lattice_shape, 3),
        to_host(torch.cat(ratios)).reshape(lattice_shape),
        to_host(torch.cat(sharps)).reshape(lattice_shape),
    )


def _clean_flow(flow_zyx: np.ndarray, ratios: np.ndarray, sharps: np.ndarray,
                cfg: SofimaRegistrationConfig) -> np.ndarray:
    """Validity mask: peak ratio, peak sharpness, magnitude, then each
    channel's deviation from the median of the surviving vectors."""
    mag = np.linalg.norm(flow_zyx, axis=-1)
    valid = (
        (ratios >= cfg.min_peak_ratio)
        & (sharps >= cfg.min_peak_sharpness)
        & (mag <= cfg.max_magnitude)
    )
    if valid.any():
        med = np.median(flow_zyx[valid], axis=0)
        dev = np.abs(flow_zyx - med).max(axis=-1)
        valid = valid & (dev <= cfg.max_deviation)
    return valid


def _relax_field(flow: torch.Tensor, measured: torch.Tensor, valid: torch.Tensor, *,
                 smoothness: float, iterations: int, tolerance: float) -> tuple[torch.Tensor, int]:
    """Jacobi relaxation of data + Laplacian smoothness in float32, on the
    tensors' device: each sweep sets ``w·measured + (1 − w)·avg`` with
    ``w = valid / (valid + smoothness)`` and ``avg`` the mean of the
    in-range face neighbours (axis 0..2, offset −1 then +1; a site with
    none keeps its value). Sweeps run while the largest change exceeds
    ``tolerance`` and fewer than ``iterations`` have run, one scalar read
    a sweep. Returns (field, sweeps)."""
    w = valid[..., None].to(torch.float32)
    data_weight = w / (w + smoothness)
    keep = 1.0 - data_weight
    shape = flow.shape[:3]
    oks = []
    for ax in range(3):
        idx = torch.arange(shape[ax], device=flow.device).reshape([shape[ax] if a == ax else 1 for a in range(3)])
        for off in (-1, 1):
            ok = ((idx - off) >= 0) & ((idx - off) < shape[ax])
            oks.append((ax, off, ok.expand(shape)[..., None].to(torch.float32)))
    count = torch.zeros_like(flow[..., :1])
    for _, _, ok in oks:
        count = count + ok
    f = flow
    delta = torch.inf
    it = 0
    while delta > tolerance and it < iterations:
        total = torch.zeros_like(f)
        for ax, off, ok in oks:
            total = total + torch.where(ok > 0, torch.roll(f, off, dims=ax), 0.0)
        avg = torch.where(count > 0, total / torch.clamp(count, min=1.0), f)
        new = data_weight * measured + keep * avg
        delta = read_scalar(torch.max(torch.abs(new - f)))
        profiling.count("flow.sweeps")
        f = new
        it += 1
    return f, it


def _compose_flow_fields_same_grid(total_xyz: np.ndarray, residual_xyz: np.ndarray,
                                   stride_zyx: np.ndarray) -> np.ndarray:
    """total'(r) = residual(r) + total(r + residual(r)) on the shared
    lattice: order-1 ``nearest`` interpolation in lattice units (float32;
    the residual over the float64 stride rounded once)."""
    fz, fy, fx = total_xyz.shape[1:]
    grids = torch.meshgrid(*[torch.arange(n, dtype=torch.float32) for n in (fz, fy, fx)], indexing="ij")
    res = np.asarray(residual_xyz, np.float32)
    steps = [
        torch.as_tensor((res[c].astype(np.float64) / stride_zyx[a]).astype(np.float32))
        for a, c in enumerate((2, 1, 0))
    ]
    coords = [g + r for g, r in zip(grids, steps)]
    total = torch.as_tensor(np.asarray(total_xyz, np.float32))
    sampled = torch.stack([_map_coordinates(total[c], coords, mode="nearest") for c in range(3)])
    return (torch.as_tensor(res) + sampled).numpy()


def estimate_sofima_flow_field_xyz_px(
    reference,
    moving,
    config: SofimaRegistrationConfig = SofimaRegistrationConfig(),
    *,
    device=None,
) -> tuple[np.ndarray, dict]:
    """The residual deformable flow of ``moving`` (already affine-registered
    into the reference frame) against ``reference``: (field (3, fz, fy,
    fx) float32, channels X, Y, Z, and the metadata the datastore keeps
    beside it). Tensors stay on their device; anything else goes to
    ``device`` (the card by default)."""
    with profiling.span("flow.estimate"):
        cfg = config
        ref = as_device_tensor(reference, device).to(torch.float32)
        moving_t = as_device_tensor(moving, ref.device).to(torch.float32)
        ref_shape = tuple(int(v) for v in ref.shape)
        patch, stride = cfg.resolve_patch_and_stride(ref_shape)
        starts = [_lattice_starts(s, p, st) for s, p, st in zip(ref_shape, patch, stride)]
        lattice_shape = tuple(len(s) for s in starts)
        box_start_zyx = [float(s[0] + p / 2.0) for s, p in zip(starts, patch)]
        meta = dict(
            map_stride_zyx_px=[float(s) for s in stride],
            map_box_start_xyz_px=[box_start_zyx[2], box_start_zyx[1], box_start_zyx[0]],
            map_box_size_xyz_px=[float((lattice_shape[a] - 1) * stride[a] + 1) for a in (2, 1, 0)],
            reference_shape_zyx_px=list(ref_shape),
            moving_shape_zyx_px=[int(v) for v in moving_t.shape],
        )
        total_xyz = np.zeros((3, *lattice_shape), np.float32)
        current = moving_t
        best_valid_count = 0
        for iteration in range(max(1, cfg.residual_iterations)):
            with profiling.span("flow.xcorr"):
                flow_zyx, ratios, sharps = _patch_xcorr_flow(
                    ref, current, patch_size=patch, strides=stride, batch_size=int(cfg.batch_size),
                    peak_min_distance=int(cfg.peak_min_distance), peak_radius=int(cfg.peak_radius),
                    max_masked=float(cfg.max_masked), normalization_epsilon=float(cfg.normalization_epsilon),
                )
            with profiling.span("flow.clean"):
                valid = _clean_flow(flow_zyx, ratios, sharps, cfg)
            valid_count = int(valid.sum())
            # the best pass sets the status: a residual pass that finds nothing
            # fresh after a productive one is still a success
            best_valid_count = max(best_valid_count, valid_count)
            if valid_count == 0:
                break
            med = np.median(flow_zyx[valid], axis=0)
            init = np.broadcast_to(med, flow_zyx.shape).astype(np.float32)
            with profiling.span("flow.relax"):
                relaxed, _ = _relax_field(
                    to_device(init, ref.device),
                    to_device(flow_zyx.astype(np.float32), ref.device),
                    to_device(valid, ref.device),
                    smoothness=cfg.relax_smoothness, iterations=cfg.relax_iterations, tolerance=cfg.relax_tolerance,
                )
                relaxed = to_host(relaxed)
            z_med = float(np.median(relaxed[..., 0]))
            relaxed[..., 0] = np.clip(
                relaxed[..., 0],
                z_med - cfg.max_local_z_displacement_px,
                z_med + cfg.max_local_z_displacement_px,
            )
            residual_xyz = np.stack([relaxed[..., 2], relaxed[..., 1], relaxed[..., 0]]).astype(np.float32)
            if iteration == 0:
                total_xyz = residual_xyz
            else:
                total_xyz = _compose_flow_fields_same_grid(total_xyz, residual_xyz, np.asarray(stride, np.float64))
            if iteration + 1 < cfg.residual_iterations:
                with profiling.span("flow.warp"):
                    stride_f = np.asarray(stride, np.float32)
                    box_f = np.asarray(box_start_zyx, np.float32)
                    k_ranges = (
                        _separable_flow_bounds(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), total_xyz,
                                               ref_shape)
                        if tuple(moving_t.shape) == ref_shape else None
                    )
                    flow_t = to_device(total_xyz, ref.device)
                    if k_ranges is not None:
                        current = _flow_warp_separable_core(
                            moving_t[None], flow_t[None], np.ones((1, 3), np.float32), np.zeros((1, 3), np.float32),
                            stride_f[None], box_f[None], k_ranges=k_ranges, out_shape=ref_shape,
                        )[0]
                    else:
                        current = _affine_flow_warp_core(
                            moving_t, flow_t, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), stride_f, box_f,
                            reference_shape=ref_shape,
                        )
        meta["sofima_status"] = "ok" if best_valid_count else "no_valid_vectors"
        meta["valid_flow_vectors"] = best_valid_count
        return total_xyz.astype(np.float32), meta
