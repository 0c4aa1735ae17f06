"""The benchmark's input generator: one production MERFISH tile from a seed.

A rewrite in PyTorch of the simulated production geometry the program's
own generator renders (one global field of spots clustered in cells and
fiducial beads; every moving round rigidly shifted and, where the
configuration asks, smoothly deformed; the second emission channel
optionally imaged through a chromatic affine at the emitter; Gaussian
spots, Poisson noise on a background of 40 counts), with a random stream
of its own. It uses no code of the program, so later changes to the
program cannot change the inputs.

Small draws (codebook, positions, genes, amplitudes, shifts, phases) come
from a CPU ``torch.Generator``; the volumes are rendered and the Poisson
noise drawn on the device, each volume's from a generator of its own.
Spot sums accumulate in 2**-20 fixed point through integer atomics, so
the same seed gives the same volumes on any run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_FIXED = float(2**20)
_WINDOW = 5  # render each spot over ±5 voxels of its nearest voxel


@dataclass
class Tile:
    gene_ids: list
    codebook: np.ndarray  # (words, bits) int64 0/1
    round_of_bit: np.ndarray
    fiducial: np.ndarray  # (1, rounds, Z, Y, X) uint16
    bits: np.ndarray  # (1, bits, Z, Y, X) uint16
    ground_truth: dict  # gene_id, global_z, global_y, global_x (µm)
    voxel_size_zyx_um: tuple
    bit_wavelengths_um: np.ndarray
    stage_positions_zyx_um: np.ndarray
    round_shifts_px_zyx: np.ndarray
    chromatic_affine_zyx_um: np.ndarray | None
    fiducial_wavelengths_um: tuple
    na: float
    ri: float


def stream_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed for one stream of one seed."""
    words = [int(seed) % 2**64, *map(int, parts)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def injection_affine(cfg: dict) -> np.ndarray:
    """The configuration's chromatic affine (µm, reference → moving)."""
    inj = cfg["chromatic_injection"]
    affine = np.eye(4)
    affine[0, 3], affine[1, 3], affine[2, 3] = inj["translation_zyx_um"]
    affine[1, 1] = affine[2, 2] = inj["yx_scale"]
    return affine


def make_codebook(n_words: int, n_bits: int, on_bits: int, min_distance: int,
                  gen: torch.Generator) -> np.ndarray:
    """Random ``on_bits``-of-``n_bits`` codewords, pairwise Hamming
    distance >= ``min_distance``, drawn until ``n_words`` are found."""
    words: list[np.ndarray] = []
    for _ in range(100000):
        w = np.zeros(n_bits, np.int64)
        w[torch.randperm(n_bits, generator=gen)[:on_bits].numpy()] = 1
        if all(np.sum(np.abs(w - u)) >= min_distance for u in words):
            words.append(w)
            if len(words) == n_words:
                return np.stack(words)
    raise ValueError("could not build the codebook")


def _rand(gen, shape, lo, hi) -> np.ndarray:
    """Uniform float64 draws in [lo, hi) (broadcast over the last axis)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    return torch.rand(shape, generator=gen, dtype=torch.float64).numpy() * (hi - lo) + lo


def render(shape, points: np.ndarray, amps: np.ndarray, sigma_zyx, device) -> torch.Tensor:
    """Sum of Gaussians (peak ``amps``) at continuous ``points`` (px),
    each over the ±5-voxel box of its nearest voxel; float32 (Z, Y, X)."""
    nz, ny, nx = shape
    vol = torch.zeros(nz * ny * nx, dtype=torch.int64, device=device)
    if len(points):
        p = torch.as_tensor(points, dtype=torch.float64, device=device)
        a = torch.as_tensor(amps, dtype=torch.float64, device=device)
        r = torch.arange(-_WINDOW, _WINDOW + 1, device=device)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
        idx = torch.round(p)[:, None, :].to(torch.int64) + offs[None]
        d2 = ((idx.to(torch.float64) - p[:, None, :]) ** 2 / (2.0 * torch.as_tensor(sigma_zyx, dtype=torch.float64, device=device) ** 2)).sum(-1)
        val = torch.round(a[:, None] * torch.exp(-d2) * _FIXED).to(torch.int64)
        lim = torch.as_tensor(shape, device=device)
        ok = ((idx >= 0) & (idx < lim)).all(-1)
        flat = (idx[..., 0] * ny + idx[..., 1]) * nx + idx[..., 2]
        vol.index_add_(0, flat[ok], val[ok])
    return (vol.to(torch.float64) / _FIXED).to(torch.float32).reshape(shape)


def _poisson_u16(rate: torch.Tensor, seed: int) -> np.ndarray:
    gen = torch.Generator(device=rate.device).manual_seed(seed)
    counts = torch.poisson(rate, generator=gen)
    return counts.clamp(0, 65535).to(torch.int32).to(torch.uint16).cpu().numpy()


def render_tile(cfg: dict, seed: int, index: int, device) -> Tile:
    """Tile ``index`` of seed ``seed`` for configuration ``cfg``."""
    gen = torch.Generator().manual_seed(stream_seed(seed, index, 0))
    shape = tuple(int(v) for v in cfg["tile_shape_zyx"])
    n_bits, n_genes, n_blanks = cfg["n_bits"], cfg["n_genes"], cfg["n_blanks"]
    n_rounds = n_bits // 2
    spacing = np.asarray(cfg["voxel_size_zyx_um"], np.float64)
    sigma = (max(cfg["axial_sigma_um"] / spacing[0], 0.25), cfg["lateral_sigma_px"], cfg["lateral_sigma_px"])
    codebook = make_codebook(n_genes + n_blanks, n_bits, cfg["on_bits"], cfg["min_hamming_distance"], gen)
    gene_ids = [f"gene{i:03d}" for i in range(n_genes)] + [f"blank{i:02d}" for i in range(n_blanks)]
    extent = np.asarray(shape, np.float64)
    margin = cfg["margin_px"]
    n_spots, n_cells = cfg["n_spots"], cfg["n_cells"]
    centers = _rand(gen, (n_cells, 3), [1.0, margin + 6, margin + 6],
                    [extent[0] - 1.0, extent[1] - margin - 6, extent[2] - margin - 6])
    which = torch.randint(0, n_cells, (n_spots,), generator=gen).numpy()
    scatter = torch.randn((n_spots, 3), generator=gen, dtype=torch.float64).numpy() * np.asarray(
        [max(shape[0] / 6.0, 1.0), cfg["cell_radius_px"], cfg["cell_radius_px"]])
    spots = np.clip(centers[which] + scatter, [1.0, margin, margin],
                    [extent[0] - 1.0, extent[1] - margin, extent[2] - margin])
    genes = torch.randint(0, n_genes, (n_spots,), generator=gen).numpy()
    amps = _rand(gen, n_spots, *cfg["spot_amplitude"])
    n_beads = cfg["n_beads"]
    beads = _rand(gen, (n_beads, 3), [1.0, 4.0, 4.0], extent - np.asarray([1.0, 4.0, 4.0]))
    bead_amps = _rand(gen, n_beads, *cfg["bead_amplitude"])
    shifts = np.zeros((n_rounds, 3))
    phases = np.zeros((n_rounds, 4))
    for r in range(1, n_rounds):
        shifts[r] = _rand(gen, 3, -1.0, 1.0) * cfg["round_shift_px"] * np.asarray([0.25, 1.0, 1.0])
        phases[r] = _rand(gen, 4, 0.0, 2 * math.pi)
    amplitude = cfg["deformation_px"]

    def deform(points, r):
        if r == 0 or amplitude == 0.0:
            return np.zeros_like(points)
        _, y, x = points.T
        ly, lx = max(extent[1], 1.0), max(extent[2], 1.0)
        dy = amplitude * np.sin(2 * np.pi * x / lx + phases[r, 0]) * np.cos(2 * np.pi * y / ly + phases[r, 1])
        dx = amplitude * np.cos(2 * np.pi * y / ly + phases[r, 2]) * np.sin(2 * np.pi * x / lx + phases[r, 3])
        dz = 0.25 * amplitude * np.sin(2 * np.pi * x / lx + phases[r, 0])
        return np.column_stack([dz, dy, dx])

    background = float(cfg["background_counts"])
    fiducial = np.empty((1, n_rounds) + shape, np.uint16)
    for r in range(n_rounds):
        local = beads + shifts[r] + deform(beads, r)
        vol = render(shape, local, bead_amps, sigma, device)
        fiducial[0, r] = _poisson_u16(vol + background, stream_seed(seed, index, 1, r))
    affine = injection_affine(cfg) if cfg.get("chromatic_injection") else None
    inverse = None if affine is None else np.linalg.inv(affine)
    bits = np.empty((1, n_bits) + shape, np.uint16)
    for b in range(n_bits):
        on = codebook[genes, b] > 0
        moved = spots[on] + shifts[b // 2] + deform(spots[on], b // 2)
        if inverse is not None and b % 2 == 1:
            # the emitter of the second channel appears at A⁻¹·q (µm, tile frame)
            um = moved * spacing
            moved = (um @ inverse[:3, :3].T + inverse[:3, 3]) / spacing
        vol = render(shape, moved, amps[on], sigma, device)
        bits[0, b] = _poisson_u16(vol + background, stream_seed(seed, index, 2, b))
    wl = cfg["readout_wavelengths_um"]
    return Tile(
        gene_ids=gene_ids,
        codebook=codebook,
        round_of_bit=np.arange(n_bits) // 2,
        fiducial=fiducial,
        bits=bits,
        ground_truth={
            "gene_id": np.asarray([gene_ids[g] for g in genes], dtype=object),
            "global_z": spots[:, 0] * spacing[0],
            "global_y": spots[:, 1] * spacing[1],
            "global_x": spots[:, 2] * spacing[2],
        },
        voxel_size_zyx_um=tuple(float(v) for v in spacing),
        bit_wavelengths_um=np.asarray([wl[b % 2] for b in range(n_bits)], np.float64),
        stage_positions_zyx_um=np.zeros((1, 3)),
        round_shifts_px_zyx=shifts,
        chromatic_affine_zyx_um=affine,
        fiducial_wavelengths_um=tuple(cfg["fiducial_wavelengths_um"]),
        na=float(cfg["na"]),
        ri=float(cfg["ri"]),
    )
