"""Synthetic raw acquisition (counterpart of the generate mode of
``merfish3d_tpu/cli/simulation/convert_simulation_to_experiment.py``).

Produces the arrays the reference writes to disk — per-tile fiducial
rounds and readout bits (uint16, Gaussian PSF + Poisson noise), the
codebook and the ground-truth spot table — in memory, numpy only. The
same arguments and seed give bit-identical arrays: every random draw of
the reference happens here in the same order, including draws whose
values this slice does not use.

The production renderer applies the reference's rigid per-round shifts
(``round_shift_px``), its smooth per-round deformation of the global
field (``deformation_px``: sinusoids over the global extent, with phases
drawn after each round's shift) and, with ``chromatic_affine_zyx_um``,
its emitter-side chromatic aberration: the second emission channel's
spots are placed at the inverse affine of their deformed position, in µm
in the tile's frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...utils.simulation import _render_bit_volume, make_mhd4_codebook


@dataclass
class RawExperiment:
    gene_ids: list
    codebook: np.ndarray  # (words, bits) int64 0/1
    round_of_bit: np.ndarray  # (bits,) 0-based
    fiducial: np.ndarray  # (tiles, rounds, Z, Y, X) uint16
    bits: np.ndarray  # (tiles, bits, Z, Y, X) uint16
    ground_truth: dict  # columns: gene_id tile_idx z y x global_z global_y global_x
    voxel_size_zyx_um: tuple
    bit_wavelengths_um: np.ndarray  # (bits, 2) excitation, emission
    stage_positions_zyx_um: np.ndarray  # (tiles, 3)
    # production renderer: the injected rigid shift of each round's field
    # (px, round 0 the reference), the reference's GT_misregistration.json
    round_shifts_px_zyx: Optional[np.ndarray] = None  # (rounds, 3)
    # production renderer: the amplitude of the smooth deformation (px)
    deformation_px: float = 0.0
    # production renderer: the chromatic affine injected at the emitter
    chromatic_affine_zyx_um: Optional[np.ndarray] = None  # (4, 4)
    # the reference's metadata.json optics
    fiducial_wavelengths_um: tuple = (0.488, 0.520)  # excitation, emission
    na: float = 1.35
    ri: float = 1.4


def _gt_columns(gene_ids, genes, spots, tile_idx, spacing) -> dict:
    return {
        "gene_id": np.asarray([gene_ids[g] for g in genes], dtype=object),
        "tile_idx": np.full(len(spots), tile_idx, np.int64),
        "z": spots[:, 0].astype(np.float64),
        "y": spots[:, 1].astype(np.float64),
        "x": spots[:, 2].astype(np.float64),
        "global_z": spots[:, 0] * spacing[0],
        "global_y": spots[:, 1] * spacing[1],
        "global_x": spots[:, 2] * spacing[2],
    }


def generate_raw_experiment(
    *,
    shape=(12, 128, 128),
    n_genes=24,
    n_blanks=4,
    n_bits=16,
    n_spots=150,
    n_tiles=1,
    voxel_size_zyx_um=(0.315, 0.098, 0.098),
    seed=0,
    distribution: str = "uniform",
    n_cells: int = 6,
    axial_sigma_um: float | None = None,
    tile_offset_px=None,
    round_shift_px: float = 0.0,
    deformation_px: float = 0.0,
    chromatic_affine_zyx_um=None,
) -> RawExperiment:
    """Generate a synthetic raw acquisition.

    ``distribution``: "uniform" scatters spots everywhere, "cells"
    clusters them around ``n_cells`` centers. ``axial_sigma_um`` fixes
    the PSF's axial extent in µm (None: a 1.4-px sigma on every axis).
    ``tile_offset_px`` set selects the production renderer: one global
    field imaged by ``n_tiles`` tiles at stage offsets
    ``tile_offset_px * tile_idx``, each moving round's beads and spots
    shifted rigidly by up to ``round_shift_px`` px (z scaled by 0.25) and
    displaced by a smooth field of amplitude ``deformation_px`` px, and
    with ``chromatic_affine_zyx_um`` its odd bits (the second emission
    wavelength) imaged through that chromatic aberration: stored(p) =
    true(A·p), the emitter rendered at A⁻¹ of its position."""
    rng = np.random.default_rng(seed)
    axial_step = float(voxel_size_zyx_um[0])
    if axial_sigma_um is not None:
        sigma_zyx = (max(float(axial_sigma_um) / axial_step, 0.25), 1.4, 1.4)
    else:
        sigma_zyx = (1.4, 1.4, 1.4)
    gene_ids, matrix_i = make_mhd4_codebook(n_genes, n_bits, n_blanks, seed=seed)
    matrix = matrix_i.astype(np.float64)
    n_rounds = n_bits // 2
    spacing = np.asarray(voxel_size_zyx_um)
    common = dict(
        gene_ids=gene_ids,
        codebook=matrix_i,
        round_of_bit=np.arange(n_bits) // 2,
        voxel_size_zyx_um=tuple(voxel_size_zyx_um),
        bit_wavelengths_um=np.asarray(
            [[0.561, 0.590] if b % 2 == 0 else [0.635, 0.670] for b in range(n_bits)]
        ),
    )
    if tile_offset_px is not None:
        return _production_tiles(
            rng, shape=shape, matrix=matrix, gene_ids=gene_ids, n_bits=n_bits,
            n_rounds=n_rounds, n_spots=n_spots, n_tiles=n_tiles, spacing=spacing,
            sigma_zyx=sigma_zyx, tile_offset_px=np.asarray(tile_offset_px, np.float64),
            distribution=distribution, n_cells=n_cells, common=common,
            round_shift_px=float(round_shift_px), deformation_px=float(deformation_px),
            chromatic_affine_zyx_um=chromatic_affine_zyx_um,
        )

    fiducial = np.empty((n_tiles, n_rounds) + tuple(shape), np.uint16)
    bits = np.empty((n_tiles, n_bits) + tuple(shape), np.uint16)
    gt_parts = []
    for tile_idx in range(n_tiles):
        margin = 8
        if distribution == "cells":
            z_lo = min(1.0, shape[0] / 4.0)
            centers = np.column_stack(
                [
                    rng.uniform(z_lo, max(shape[0] - z_lo, z_lo + 0.1), n_cells),
                    rng.uniform(margin + 6, shape[1] - margin - 6, n_cells),
                    rng.uniform(margin + 6, shape[2] - margin - 6, n_cells),
                ]
            )
            which = rng.integers(0, n_cells, n_spots)
            scatter = rng.normal(0.0, 1.0, (n_spots, 3)) * np.asarray(
                [max(shape[0] / 6.0, 1.0), 7.0, 7.0]
            )
            spots = np.clip(
                centers[which] + scatter,
                [1.0, margin, margin],
                [shape[0] - 1.0, shape[1] - margin, shape[2] - margin],
            )
        elif distribution == "uniform":
            spots = np.column_stack(
                [
                    rng.uniform(2, shape[0] - 2, n_spots),
                    rng.uniform(margin, shape[1] - margin, n_spots),
                    rng.uniform(margin, shape[2] - margin, n_spots),
                ]
            )
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        genes = rng.integers(0, n_genes, n_spots)
        amps = rng.uniform(800, 2000, n_spots)
        gt_parts.append(_gt_columns(gene_ids, genes, spots, tile_idx, spacing))
        beads = np.column_stack(
            [
                rng.uniform(1, shape[0] - 1, 60),
                rng.uniform(4, shape[1] - 4, 60),
                rng.uniform(4, shape[2] - 4, 60),
            ]
        )
        fid = _render_bit_volume(
            shape, beads, rng.uniform(500, 1500, 60), sigma_zyx=sigma_zyx
        )
        for r in range(n_rounds):
            fiducial[tile_idx, r] = rng.poisson(fid + 40).astype(np.uint16)
        for b in range(n_bits):
            on = matrix[genes, b] > 0
            vol = _render_bit_volume(shape, spots[on], amps[on], sigma_zyx=sigma_zyx)
            bits[tile_idx, b] = rng.poisson(vol + 40).astype(np.uint16)
    return RawExperiment(
        fiducial=fiducial,
        bits=bits,
        ground_truth={k: np.concatenate([p[k] for p in gt_parts]) for k in gt_parts[0]},
        stage_positions_zyx_um=np.zeros((n_tiles, 3)),
        **common,
    )


def _production_tiles(
    rng, *, shape, matrix, gene_ids, n_bits, n_rounds, n_spots, n_tiles,
    spacing, sigma_zyx, tile_offset_px, distribution, n_cells, common, round_shift_px,
    deformation_px=0.0, chromatic_affine_zyx_um=None,
) -> RawExperiment:
    """Production-geometry renderer: one global spot/bead field imaged by
    overlapping tiles, each moving round rigidly shifted and smoothly
    deformed, the second emission channel optionally chromatically
    aberrated."""
    shape = np.asarray(shape, int)
    offsets_px = [tile_offset_px * t for t in range(n_tiles)]
    extent_px = shape.astype(np.float64) + offsets_px[-1]
    margin = 8
    coding = [i for i, g in enumerate(gene_ids) if not g.lower().startswith("blank")]
    if distribution == "cells":
        centers = np.column_stack(
            [
                rng.uniform(1.0, extent_px[0] - 1.0, n_cells),
                rng.uniform(margin + 6, extent_px[1] - margin - 6, n_cells),
                rng.uniform(margin + 6, extent_px[2] - margin - 6, n_cells),
            ]
        )
        which = rng.integers(0, n_cells, n_spots)
        scatter = rng.normal(0.0, 1.0, (n_spots, 3)) * np.asarray(
            [max(shape[0] / 6.0, 1.0), 30.0, 30.0]
        )
        global_spots = np.clip(
            centers[which] + scatter,
            [1.0, margin, margin],
            [extent_px[0] - 1.0, extent_px[1] - margin, extent_px[2] - margin],
        )
    else:
        global_spots = np.column_stack(
            [
                rng.uniform(2, extent_px[0] - 2, n_spots),
                rng.uniform(margin, extent_px[1] - margin, n_spots),
                rng.uniform(margin, extent_px[2] - margin, n_spots),
            ]
        )
    genes = np.asarray(coding)[rng.integers(0, len(coding), n_spots)]
    amps = rng.uniform(800, 2000, n_spots)
    n_beads = 80 * n_tiles
    global_beads = np.column_stack(
        [
            rng.uniform(1, extent_px[0] - 1, n_beads),
            rng.uniform(4, extent_px[1] - 4, n_beads),
            rng.uniform(4, extent_px[2] - 4, n_beads),
        ]
    )
    bead_amps = rng.uniform(500, 1500, n_beads)
    # per-moving-round rigid shift (z scaled down: stage drift is mostly
    # lateral) and deformation phases; round 0 is the reference
    shifts = np.zeros((n_rounds, 3))
    phases = np.zeros((n_rounds, 4))
    for r in range(1, n_rounds):
        shifts[r] = rng.uniform(-1.0, 1.0, 3) * round_shift_px * np.asarray([0.25, 1.0, 1.0])
        phases[r] = rng.uniform(0, 2 * np.pi, 4)

    def deform(points_global, r):
        """Smooth low-frequency displacement (px) of global positions in
        round r's frame."""
        if r == 0 or deformation_px == 0.0:
            return np.zeros_like(points_global)
        z, y, x = points_global.T
        ly = max(float(extent_px[1]), 1.0)
        lx = max(float(extent_px[2]), 1.0)
        dy = deformation_px * np.sin(2 * np.pi * x / lx + phases[r, 0]) * np.cos(2 * np.pi * y / ly + phases[r, 1])
        dx = deformation_px * np.cos(2 * np.pi * y / ly + phases[r, 2]) * np.sin(2 * np.pi * x / lx + phases[r, 3])
        dz = 0.25 * deformation_px * np.sin(2 * np.pi * x / lx + phases[r, 0])
        return np.column_stack([dz, dy, dx])

    shape_t = tuple(int(v) for v in shape)
    fiducial = np.empty((n_tiles, n_rounds) + shape_t, np.uint16)
    bits = np.empty((n_tiles, n_bits) + shape_t, np.uint16)
    stage_positions = []
    for tile_idx in range(n_tiles):
        offset = offsets_px[tile_idx]
        stage_positions.append(offset * spacing)
        for r in range(n_rounds):
            local = global_beads + shifts[r] + deform(global_beads, r) - offset
            inside = np.all((local > -5) & (local < shape.astype(float) + 5), axis=1)
            fid = _render_bit_volume(shape_t, local[inside], bead_amps[inside], sigma_zyx=sigma_zyx)
            fiducial[tile_idx, r] = rng.poisson(fid + 40).astype(np.uint16)
        inv_chromatic = (
            np.linalg.inv(np.asarray(chromatic_affine_zyx_um, np.float64))
            if chromatic_affine_zyx_um is not None
            else None
        )
        for b in range(n_bits):
            on = matrix[genes, b] > 0
            moved = global_spots[on] + shifts[b // 2] + deform(global_spots[on], b // 2)
            if inv_chromatic is not None and b % 2 == 1:
                # the emitter appears at A⁻¹·q: the affine acts on µm in
                # this tile's frame, the contract the decoder inverts
                local_um = (moved - offset) * spacing
                local_um = local_um @ inv_chromatic[:3, :3].T + inv_chromatic[:3, 3]
                moved = local_um / spacing + offset
            local = moved - offset
            inside = np.all((local > -5) & (local < shape.astype(float) + 5), axis=1)
            vol = _render_bit_volume(
                shape_t, local[inside], amps[on][inside], sigma_zyx=sigma_zyx
            )
            bits[tile_idx, b] = rng.poisson(vol + 40).astype(np.uint16)
    return RawExperiment(
        fiducial=fiducial,
        bits=bits,
        ground_truth=_gt_columns(gene_ids, genes, global_spots, -1, spacing),
        stage_positions_zyx_um=np.asarray(stage_positions),
        round_shifts_px_zyx=shifts,
        deformation_px=float(deformation_px),
        chromatic_affine_zyx_um=(
            None if chromatic_affine_zyx_um is None else np.asarray(chromatic_affine_zyx_um, np.float64)
        ),
        **common,
    )
