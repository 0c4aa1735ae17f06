"""What a tile's run produced, and the numbers that hold it to the
reference.

The reference follows the run in two stages. Registration: the reference
registers, deconvolves and scores the same raw tile itself, and the run's
round shifts, flow fields, stored fiducials, stored deconvolved stack and
stored spot probabilities (its handoff to the decode) are held to the
reference's own, over every round and readout bit. Decode: the reference
decodes the run's handoff, following the run's own state from pass to
pass (:func:`.reference.chain.replay_decode`: the normalization vectors
and chromatic affines each pass uses are worked out from the run's table
of the pass before), and every pass's table, the final table before the
filter, the filter's output (the reference's filter run on the run's own
final table) and the chromatic affine are held to the reference's. The decode follows the
run's state because two runs of a decode that differ only in FP32
rounding pick different near-tie voxels, and the chromatic estimate's
random sampling turns one differing row into a different affine for the
next pass; followed pass by pass, the rounding shows alone.

Each number has a limit of its own in the cell's workload file:

- ``shift_px``: the largest gap between the round translations, px;
- ``flow_px``: the largest gap between the flow fields, px, over every
  lattice site of every moving round;
- ``flow_valid``: the gap between the counts of valid flow vectors,
  summed over the rounds;
- ``decon_l2``: the L2 norm of the gap between the stored deconvolved
  stacks, over the reference's;
- ``fid_decon_l2``: with fiducial deconvolution, the same over every
  round's stored fiducial (round 0 deconvolved, the moving rounds
  deconvolved and warped): the round shifts move only by whole tenths of
  a pixel, so a fault in the fiducials' values can leave them unmoved;
- ``prob_l1``: the L1 norm of the gap between the stored spot
  probabilities (u8), over the reference's;
- ``affine``: the largest gap between the chromatic affines' entries
  (translations in µm);
- ``table_miss``: over every pass's table, the final one and the
  filtered one, the largest
  share of the rows of both tables that find no same-gene row of the
  other within 1 px;
- ``table_values``: over the same tables, the largest median, over the
  matched rows, of each row's L2 gap between its per-bit mean
  intensities over the reference row's norm (the median, because a row
  whose component gained or lost a near-tie voxel moves by a few percent
  while the others agree);
- ``gene_swaps``: over the same tables, the largest count of rows that
  find no same-gene row of the other table within 1 px but a row of
  another gene within 0.5 px: one answer given another gene where it is
  produced reads 2 (its row and the other table's), where a near-tie
  voxel, which adds or drops a row or moves it, reads nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from .f1 import matched_pairs


@dataclass
class TileOutput:
    transforms: dict  # round -> 4x4 µm
    flows: dict  # round -> (field (3, fz, fy, fx), attrs)
    registered: dict  # bit -> u16 (Z, Y, X)
    fiducials: dict  # round -> u16 (Z, Y, X), registered into round 0's frame
    predictor: dict  # bit -> u8 (Z, Y, X)
    table: Optional[dict] = None  # the filtered decoded table
    decoded: Optional[dict] = None  # the final table before the filter
    passes: Optional[list] = None  # the normalization passes' tables
    chromatic: Optional[np.ndarray] = None  # 4x4 µm affine of the non-reference channel


def capture(store, table=None) -> TileOutput:
    """The judged outputs of a finished tile's store (program or reference)."""
    chromatic = None
    calibration = store.load_chromatic_affine_transforms_zyx_um()
    if calibration:
        moving = [c for c in calibration["channels"].values() if not c["reference_channel"]]
        if moving:
            chromatic = np.asarray(moving[0]["affine_zyx_um"], np.float64)
    return TileOutput(
        transforms={r: np.asarray(t, np.float64) for (_, r), t in store.round_transforms.items()},
        flows={r: flow for (_, r), flow in store.flow_fields.items()},
        registered={b: v for (_, b), v in store.registered.items()},
        fiducials={r: v for (_, r), v in store.fiducial_registered.items()},
        predictor={b: v for (_, b), v in store.feature_predictor.items()},
        table=table,
        decoded=store.decoded_tables.get(0),
        passes=[store.iteration_checkpoints[it] for it in sorted(store.iteration_checkpoints)],
        chromatic=chromatic,
    )


def _rel_norm(pairs, order: int) -> float:
    num = den = 0.0
    for g, w in pairs:
        g, w = g.astype(np.float64), w.astype(np.float64)
        num += float(np.sum(np.abs(g - w) ** order))
        den += float(np.sum(np.abs(w) ** order))
    return float((num / max(den, 1e-300)) ** (1.0 / order))


def shift_residual_px(got: TileOutput, tile) -> float:
    """The largest residual of the round shifts against those the
    generator injected, px (reported, not compared)."""
    spacing = np.asarray(tile.voxel_size_zyx_um, np.float64)
    return max(float(np.max(np.abs(got.transforms[r][:3, 3] / spacing - tile.round_shifts_px_zyx[r])))
               for r in range(len(tile.round_shifts_px_zyx)))


def registration_gaps(got: TileOutput, want: TileOutput, tile, *, decon: bool, flow: bool,
                      fid_decon: bool = False) -> dict:
    """The handoff of ``got`` held to the reference's own registration of
    ``tile``."""
    spacing = np.asarray(tile.voxel_size_zyx_um, np.float64)
    out = {"shift_px": max(float(np.max(np.abs(got.transforms[r][:3, 3] - want.transforms[r][:3, 3]) / spacing))
                           for r in want.transforms)}
    if flow:
        if sorted(got.flows) != sorted(want.flows):
            out["flow_px"] = out["flow_valid"] = float("inf")
        else:
            out["flow_px"] = max(float(np.max(np.abs(np.asarray(got.flows[r][0], np.float64)
                                                     - np.asarray(want.flows[r][0], np.float64))))
                                 for r in want.flows)
            out["flow_valid"] = float(sum(abs(int(got.flows[r][1]["valid_flow_vectors"])
                                              - int(want.flows[r][1]["valid_flow_vectors"])) for r in want.flows))
    if fid_decon:
        out["fid_decon_l2"] = _rel_norm([(got.fiducials[r], v) for r, v in want.fiducials.items()], 2)
    if decon:
        out["decon_l2"] = _rel_norm([(got.registered[b], v) for b, v in want.registered.items()], 2)
    out["prob_l1"] = _rel_norm([(got.predictor[b], v) for b, v in want.predictor.items()], 1)
    return out


def decode_gaps(got: TileOutput, passes: list, final: dict, filtered: dict, affine, *, chromatic: bool) -> dict:
    """The decode of ``got`` held to the reference's replay of it: its pass
    tables, final table, filtered table and chromatic affine."""
    out = {}
    if chromatic:
        if got.chromatic is None or affine is None:
            out["affine"] = float("inf")
        else:
            out["affine"] = float(np.max(np.abs(got.chromatic[:3] - affine[:3])))
    if len(got.passes) != len(passes):
        out["table_miss"] = out["table_values"] = out["gene_swaps"] = float("inf")
        return out
    pairs = [(concat(g), w) for g, w in zip(got.passes, passes)] + [(got.decoded, final), (got.table, filtered)]
    gaps = [table_gaps(g, w) for g, w in pairs]
    out["table_miss"] = max(g[0] for g in gaps)
    out["table_values"] = max(g[1] for g in gaps)
    out["gene_swaps"] = float(max(g[2] for g in gaps))
    return out


def concat(frames: list) -> dict:
    """One table of a pass's per-tile frames."""
    from .reference.filtering import concat_tables

    return concat_tables(frames)


def table_gaps(a: dict, b: dict, radius_px: float = 1.0, swap_px: float = 0.5) -> tuple[float, float, int]:
    """(share of the rows of both tables left unmatched, median relative L2
    gap of the matched rows' per-bit mean intensities, unmatched rows with
    a row of another gene within ``swap_px``)."""
    n_a = len(a["gene_id"]) if a else 0
    n_b = len(b["gene_id"]) if b else 0
    if n_a + n_b == 0:
        return 0.0, 0.0, 0
    if n_a == 0 or n_b == 0:
        return 1.0, float("inf"), 0
    pts = [np.stack([np.asarray(t[c], float) for c in ("z", "y", "x")], axis=1) for t in (a, b)]
    genes = [np.asarray(t["gene_id"]).astype(str) for t in (a, b)]
    pairs = matched_pairs(genes[0], pts[0], genes[1], pts[1], radius_px)
    miss = (n_a + n_b - 2 * len(pairs)) / (n_a + n_b)
    swaps = 0
    for side, other in ((0, 1), (1, 0)):
        unmatched = sorted(set(range(len(genes[side]))) - {p[side] for p in pairs})
        near = cKDTree(pts[other]).query_ball_point(pts[side][unmatched], swap_px) if unmatched else []
        swaps += sum(any(genes[other][j] != genes[side][i] for j in js) for i, js in zip(unmatched, near))
    if not pairs:
        return miss, float("inf"), swaps
    cols = sorted(c for c in b if c.startswith("bit") and c.endswith("_mean_intensity"))
    ia, ib = (np.asarray(v) for v in zip(*pairs))
    va = np.stack([np.asarray(a[c], np.float64)[ia] for c in cols], axis=1)
    vb = np.stack([np.asarray(b[c], np.float64)[ib] for c in cols], axis=1)
    rel = np.linalg.norm(va - vb, axis=1) / np.maximum(np.linalg.norm(vb, axis=1), 1e-300)
    return miss, float(np.median(rel)), swaps
