import numpy as np
import pytest

from benchmark.generator import injection_affine, render_tile
from benchmark.harness import load_cell
from benchmark.tests import SMALL


def config(name="prod_rigid-nodecon", **over):
    return {**load_cell(name)[2], **SMALL, **over}


def test_same_seed_same_tile():
    cfg = config()
    a, b = render_tile(cfg, 2**31 + 11, 0, "cpu"), render_tile(cfg, 2**31 + 11, 0, "cpu")
    for name in ("bits", "fiducial", "codebook", "round_shifts_px_zyx"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.ground_truth["gene_id"].tolist() == b.ground_truth["gene_id"].tolist()


@pytest.mark.parametrize("other", [(2**31 + 12, 0), (2**31 + 11, 1)])
def test_other_seed_or_index_other_tile(other):
    cfg = config()
    a, b = render_tile(cfg, 2**31 + 11, 0, "cpu"), render_tile(cfg, *other, "cpu")
    assert not np.array_equal(a.bits, b.bits)
    assert not np.array_equal(a.ground_truth["global_x"], b.ground_truth["global_x"])


def test_shapes_dtypes_and_ground_truth_follow_the_config():
    cfg = config()
    tile = render_tile(cfg, 7, 0, "cpu")
    shape = tuple(cfg["tile_shape_zyx"])
    assert tile.bits.shape == (1, cfg["n_bits"], *shape) and tile.bits.dtype == np.uint16
    assert tile.fiducial.shape == (1, cfg["n_bits"] // 2, *shape) and tile.fiducial.dtype == np.uint16
    assert tile.codebook.shape == (cfg["n_genes"] + cfg["n_blanks"], cfg["n_bits"])
    assert (tile.codebook.sum(axis=1) == cfg["on_bits"]).all()
    diff = np.abs(tile.codebook[:, None] - tile.codebook[None]).sum(-1)
    assert diff[~np.eye(len(diff), dtype=bool)].min() >= cfg["min_hamming_distance"]
    gt = tile.ground_truth
    assert len(gt["gene_id"]) == cfg["n_spots"]
    assert all(g.startswith("gene") for g in gt["gene_id"])
    spacing = np.asarray(cfg["voxel_size_zyx_um"])
    for axis, col in enumerate(("global_z", "global_y", "global_x")):
        px = np.asarray(gt[col]) / spacing[axis]
        assert px.min() >= 0 and px.max() <= shape[axis]
    shifts = tile.round_shifts_px_zyx
    assert np.all(shifts[0] == 0) and np.all(np.abs(shifts) <= cfg["round_shift_px"] * np.asarray([0.25, 1, 1]))
    assert tile.bits.mean() > cfg["background_counts"] * 0.9


def test_chromatic_injection_moves_the_second_channel_only():
    base = config("prod_deformed-decon", deformation_px=0.0)
    plain = render_tile({**base, "chromatic_injection": None}, 5, 0, "cpu")
    injected = render_tile(base, 5, 0, "cpu")
    assert injection_affine(base)[0, 3] == pytest.approx(0.18)
    for b in range(base["n_bits"]):
        same = np.array_equal(plain.bits[0, b], injected.bits[0, b])
        assert same == (b % 2 == 0)
