"""The port's chromatic-aberration modules against the JAX reference's, on
the same numpy inputs, on CPU: the RNA-derived estimator
(pipeline/chromatic.py), the weighted on-bit centroid sums
(ops/cc.component_stats_host), the store's calibration lookup, the
generator's emitter-side injection, convert_data's image-warp injection
and the bead calibration (utils/chromatic_calibration.py).
"""

import json
import warnings
from dataclasses import dataclass

import numpy as np
import pandas as pd
import pytest
import torch

from merfish3d_tpu.cli.simulation import convert_to_datastore as jconvert
from merfish3d_tpu.cli.simulation.convert_simulation_to_experiment import write_raw_experiment
from merfish3d_tpu.ops import cc as jcc
from merfish3d_tpu.pipeline import chromatic as jchrom
from merfish3d_tpu.utils import chromatic_calibration as jbead
from merfish3d_tpu_torch.cli.simulation import convert_to_datastore as tconvert
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
    generate_raw_experiment,
)
from merfish3d_tpu_torch.datastore.array_store import ArrayStore, _json_safe
from merfish3d_tpu_torch.ops import cc as tcc
from merfish3d_tpu_torch.pipeline import chromatic as tchrom
from merfish3d_tpu_torch.utils import chromatic_calibration as tbead

SPACING = np.array([0.32, 0.098, 0.098], dtype=np.float32)
BIT_WAVELENGTHS = [[0.49, 0.58], [0.49, 0.58], [0.63, 0.67], [0.63, 0.67]]


# ------------------------------------------------ the estimator's tables
# (copied from tests/test_chromatic_estimator.py)
@dataclass
class _FakeDataStore:
    voxel_size_zyx_um: np.ndarray
    bit_ids: list
    tile_ids: list
    calibration: dict | None = None

    def load_local_wavelengths_um(self, tile, bit):
        return tuple(BIT_WAVELENGTHS[self.bit_ids.index(bit)])

    def load_chromatic_affine_transforms_zyx_um(self):
        return self.calibration or {}

    def save_chromatic_affine_transforms_zyx_um(self, calibration):
        self.calibration = calibration


def _true_affine():
    affine = np.eye(4)
    affine[0, 3] = 0.18
    affine[1, 1] = 0.9982
    affine[1, 3] = 0.42
    affine[2, 2] = 0.9982
    affine[2, 3] = -0.31
    return affine


def _transform(affine, pts):
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (homo @ affine.T)[:, :3]


def _empty_row():
    row = {"on_bit_1": 1, "on_bit_2": 2, "on_bit_3": 3, "on_bit_4": 4, "gene_id": "GeneA"}
    for b in range(1, 5):
        for sfx in ("center_z", "center_y", "center_x", "intensity_sum"):
            row[f"bit{b:02d}_{sfx}"] = np.nan
    return row


def _add_center(row, b, center_px, weight):
    row[f"bit{b:02d}_center_z"] = float(center_px[0])
    row[f"bit{b:02d}_center_y"] = float(center_px[1])
    row[f"bit{b:02d}_center_x"] = float(center_px[2])
    row[f"bit{b:02d}_intensity_sum"] = float(weight)


def _make_table(spacing, true_affine, n_good=500, n_outliers=300, n_same_wl=500, n_blank=900, seed=12345):
    rng = np.random.default_rng(seed)
    inv = np.linalg.inv(true_affine)
    blank_affine = np.eye(4)
    blank_affine[:3, 3] = [-0.8, -5.0, 4.0]
    inv_blank = np.linalg.inv(blank_affine)
    rows = []
    ref_pts = np.column_stack(
        [rng.uniform(2, 18, n_good), rng.uniform(0, 200, n_good), rng.uniform(0, 200, n_good)]
    )
    red_pts = _transform(inv, ref_pts)
    for rp, dp in zip(ref_pts, red_pts):
        row = _empty_row()
        for b in (1, 2):
            _add_center(row, b, (rp + rng.normal(0, 0.035, 3)) / spacing, rng.uniform(80, 140))
        for b in (3, 4):
            _add_center(row, b, (dp + rng.normal(0, 0.035, 3)) / spacing, rng.uniform(80, 140))
        rows.append(row)
    for _ in range(n_outliers):
        row = _empty_row()
        rp = np.array([rng.uniform(2, 18), rng.uniform(0, 200), rng.uniform(0, 200)])
        dp = np.array([rng.uniform(2, 18), rng.uniform(0, 200), rng.uniform(0, 200)])
        for b in (1, 2):
            _add_center(row, b, (rp + rng.normal(0, 0.035, 3)) / spacing, rng.uniform(80, 140))
        for b in (3, 4):
            _add_center(row, b, (dp + rng.normal(0, 0.035, 3)) / spacing, rng.uniform(80, 140))
        rows.append(row)
    for _ in range(n_same_wl):
        row = _empty_row()
        p = np.array([rng.uniform(2, 18), rng.uniform(0, 200), rng.uniform(0, 200)])
        if rng.random() < 0.5:
            row.update({"on_bit_1": 1, "on_bit_2": 2, "on_bit_3": 1, "on_bit_4": 2})
            bits = (1, 2)
        else:
            row.update({"on_bit_1": 3, "on_bit_2": 4, "on_bit_3": 3, "on_bit_4": 4})
            bits = (3, 4)
        for b in bits:
            _add_center(row, b, (p + rng.normal(0, 0.035, 3)) / spacing, rng.uniform(80, 140))
        rows.append(row)
    blank_ref = np.column_stack(
        [rng.uniform(2, 18, n_blank), rng.uniform(0, 200, n_blank), rng.uniform(0, 200, n_blank)]
    )
    blank_red = _transform(inv_blank, blank_ref)
    for rp, dp in zip(blank_ref, blank_red):
        row = _empty_row()
        row["gene_id"] = "Blank-1"
        for b in (1, 2):
            _add_center(row, b, (rp + rng.normal(0, 0.015, 3)) / spacing, rng.uniform(200, 260))
        for b in (3, 4):
            _add_center(row, b, (dp + rng.normal(0, 0.015, 3)) / spacing, rng.uniform(200, 260))
        rows.append(row)
    return pd.DataFrame(rows).sample(frac=1, random_state=42).reset_index(drop=True)


def _invalid_rows() -> pd.DataFrame:
    """Empty and missing gene ids, out-of-range on-bits, NaN centers."""
    invalid = []
    for gene in ("", None):
        row = _empty_row()
        row["gene_id"] = gene
        _add_center(row, 1, [5, 50, 50], 1000.0)
        _add_center(row, 3, [5, 90, 90], 1000.0)
        invalid.append(row)
    row = _empty_row()
    row.update({"on_bit_1": 99, "on_bit_2": 98, "on_bit_3": 97, "on_bit_4": 96})
    for b in range(1, 5):
        _add_center(row, b, [5, 40, 40], 1000.0)
    invalid.append(row)
    row = _empty_row()
    for b in range(1, 5):
        _add_center(row, b, [5, 60, 60], 1000.0)
    row["bit03_center_y"] = np.nan
    row["bit04_center_y"] = np.nan
    invalid.append(row)
    return pd.DataFrame(invalid)


def _stores():
    ref = _FakeDataStore(voxel_size_zyx_um=SPACING, bit_ids=["bit001", "bit002", "bit003", "bit004"],
                         tile_ids=["tile0000"])
    port = ArrayStore(gene_ids=["GeneA"], codebook_matrix=np.ones((1, 4)), num_tiles=1,
                      voxel_size_zyx_um=SPACING, round_of_bit=[0, 0, 1, 1],
                      bit_wavelengths_um=BIT_WAVELENGTHS, stage_positions_zyx_um=[[0.0, 0.0, 0.0]])
    return ref, port


def _payload(calibration) -> str:
    """The calibration as the JSON text a store keeps (NaN included)."""
    return json.dumps(_json_safe(calibration), sort_keys=True)


@pytest.mark.parametrize("case", ["distractors", "invalid_rows", "second_pass"])
def test_estimator_bit_identical_to_reference(case):
    """Affines, statuses and every diagnostic equal the reference's; the
    second pass composes its residual fit with the first pass's affine."""
    table = _make_table(SPACING, _true_affine())
    if case == "invalid_rows":
        table = pd.concat([_make_table(SPACING, _true_affine(), n_good=200, n_outliers=0, n_same_wl=0,
                                       n_blank=0), _invalid_rows()], ignore_index=True)
    ref, port = _stores()
    config = jchrom.ChromaticAffineEstimationConfig(min_pairs=20)
    port_config = tchrom.ChromaticAffineEstimationConfig(min_pairs=20)
    columns = {c: table[c].to_numpy() for c in table.columns}
    for _ in range(2 if case == "second_pass" else 1):
        jchrom.estimate_chromatic_affines_from_barcodes(ref, table, n_merfish_bits=4, config=config)
        tchrom.estimate_chromatic_affines_from_barcodes(port, columns, n_merfish_bits=4, config=port_config)
    assert _payload(port.load_chromatic_affine_transforms_zyx_um()) == _payload(ref.calibration)
    channel = port.chromatic_calibration["channels"]["wavelength_0.670000"]
    assert channel["status"] == "affine_estimated"
    if case != "second_pass":
        np.testing.assert_allclose(np.asarray(channel["affine_zyx_um"]), _true_affine(), atol=0.006)


def test_identity_initialization_and_config_match_reference():
    ref, port = _stores()
    jchrom.save_identity_chromatic_affines(ref, 4)
    tchrom.save_identity_chromatic_affines(port, 4)
    assert _payload(port.load_chromatic_affine_transforms_zyx_um()) == _payload(ref.calibration)
    assert tchrom.ChromaticAffineEstimationConfig().__dict__ == jchrom.ChromaticAffineEstimationConfig().__dict__
    sheared = _true_affine()
    sheared[1, 2] = 0.1
    shifted = _true_affine()
    shifted[0, 3] = 2.0
    config = tchrom.ChromaticAffineEstimationConfig()
    for a in (_true_affine(), np.diag([1, 0.8, 0.8, 1.0]), sheared, shifted):
        assert tchrom._plausible(a, SPACING, config) == jchrom._plausible(a, SPACING, config)


def test_fit_degenerate_inputs_match_reference():
    cfg_j = jchrom.ChromaticAffineEstimationConfig(min_pairs=5)
    cfg_t = tchrom.ChromaticAffineEstimationConfig(min_pairs=5)
    line = np.column_stack([np.zeros(30), np.arange(30.0), np.arange(30.0)])
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0, 20, (30, 3))
    cases = [
        (np.zeros((3, 3)), np.zeros((3, 3)), None),  # too few pairs
        (line, line, None),  # rank-deficient lateral geometry
        (cloud, cloud[:, :2], None),  # shapes differ
        (cloud, cloud + 0.1, np.zeros(30)),  # no positive weight
        (cloud, cloud + 0.1, np.ones(29)),  # weight shape
        (cloud, cloud + [0.2, 0.3, -0.1], rng.uniform(1, 2, 30)),  # a clean fit
    ]
    for src, tgt, w in cases:
        want, wdiag = jchrom.fit_affine_zyx_um(src, tgt, weights=w, min_pairs=5, config=cfg_j)
        got, gdiag = tchrom.fit_affine_zyx_um(src, tgt, weights=w, min_pairs=5, config=cfg_t)
        assert _payload(gdiag) == _payload(wdiag)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- centroid statistics
def test_component_stats_weighted_centroids_exact():
    """bit_sums and bit_w_coord_sums of the port, on tensors, equal the
    reference's with dense and sparse labels and dense and gathered
    intensities."""
    import scipy.ndimage

    rng = np.random.default_rng(5)
    shape = (4, 12, 14)
    decoded = np.where(rng.random(shape) < 0.35, rng.integers(0, 5, shape), -1).astype(np.int32)
    comp, n = scipy.ndimage.label(decoded >= 0)
    lin = np.arange(decoded.size).reshape(shape)
    roots = scipy.ndimage.minimum(lin, comp, index=np.arange(1, n + 1)).astype(np.int64)
    labels = np.where(comp > 0, roots[np.maximum(comp, 1) - 1], -1)
    distance = rng.random(shape).astype(np.float16)
    magnitude = rng.random(shape).astype(np.float16)
    scaled = rng.random((6,) + shape).astype(np.float32)
    fg = np.flatnonzero(labels.ravel() >= 0)
    sparse_labels = (fg, labels.ravel()[fg])
    kw = dict(collect_weighted_centroids=True)
    args = (torch.as_tensor(distance), torch.as_tensor(magnitude), torch.as_tensor(scaled))
    dec_t = torch.as_tensor(decoded.astype(np.int16))
    got = tcc.component_stats_host(dec_t, tuple(torch.as_tensor(a) for a in sparse_labels), *args, **kw)
    for lab in (labels, sparse_labels):
        for intensity in (scaled, jcc.SparseIntensity(fg, scaled.reshape(6, -1)[:, fg])):
            want = jcc.component_stats_host(decoded, lab, distance.astype(np.float32),
                                            magnitude.astype(np.float32), intensity, **kw)
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    no_labels = (torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64))
    empty = tcc.component_stats_host(dec_t, no_labels, *args, **kw)
    assert empty["bit_w_coord_sums"].shape == (6, 0, 3)


# ------------------------------------------------------- store lookup
def test_calibration_lookup_matches_qi2lab_store(tmp_path):
    from merfish3d_tpu.datastore import qi2labDataStore

    ref_ds = qi2labDataStore(tmp_path / "qi2labdatastore")
    _, port = _stores()
    affine = _true_affine()
    structured = {
        "reference_wavelength_um": 0.58,
        "channels": {
            "wavelength_0.580000": {"channel_index": 0, "wavelength_um": 0.58, "affine_zyx_um": np.eye(4)},
            "wavelength_0.670000": {"channel_index": 1, "wavelength_um": 0.67, "affine_zyx_um": affine},
            "no_affine": {"channel_index": 2, "wavelength_um": 0.75},
        },
    }
    flat = {"0.58": np.eye(4), "0.67": affine.ravel(), "far_red": 2 * affine}
    queries = [dict(wavelength_um=0.67), dict(wavelength_um=0.6700000001), dict(wavelength_um=0.7),
               dict(channel_name="wavelength_0.670000"), dict(channel_name="far_red"),
               dict(channel_index=1), dict(channel_index=2), dict(wavelength_um=0.75), dict()]
    for payload in (structured, flat):
        ref_ds.save_chromatic_affine_transforms_zyx_um(payload, diagnostics={"n": np.int64(3)})
        port.save_chromatic_affine_transforms_zyx_um(payload, diagnostics={"n": np.int64(3)})
        assert _payload(port.load_chromatic_affine_transforms_zyx_um()) == _payload(
            ref_ds.load_chromatic_affine_transforms_zyx_um())
        for q in queries:
            want = ref_ds.load_chromatic_affine_transform_zyx_um(**q)
            got = port.load_chromatic_affine_transform_zyx_um(**q)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=str(q))
    version = port.chromatic_version
    port.save_chromatic_affine_transforms_zyx_um({})
    assert port.chromatic_version == version + 1
    np.testing.assert_array_equal(port.chromatic_transform(0.67), np.eye(4))


# ------------------------------------------------------------ injection
def test_generator_with_emitter_injection_bit_identical(tmp_path):
    """The production renderer with a chromatic affine at the emitter."""
    affine = jconvert.make_injection_affine()
    kw = dict(shape=(6, 48, 64), n_spots=40, n_genes=12, n_blanks=3, seed=5,
              voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells", axial_sigma_um=0.44,
              tile_offset_px=(0.0, 0.0, 51.0), n_cells=8, round_shift_px=1.5)
    write_raw_experiment(tmp_path, chromatic_affine_zyx_um=affine, **kw)
    raw = generate_raw_experiment(chromatic_affine_zyx_um=tconvert.make_injection_affine(), **kw)
    plain = generate_raw_experiment(**kw)
    for b in range(16):
        np.testing.assert_array_equal(raw.bits[0, b], np.load(tmp_path / "tile0000" / f"bit{b + 1:03d}.npy"))
    # the injection moved the spots of the second emission channel only
    assert not np.array_equal(raw.bits[0, 1], plain.bits[0, 1])
    np.testing.assert_array_equal(raw.bits[0, 0], plain.bits[0, 0])
    np.testing.assert_array_equal(raw.chromatic_affine_zyx_um, affine)


def test_convert_data_injection_matches_reference(tmp_path):
    """Image-warp injection at conversion against the reference's stored
    uint16 bits: a float32 warp truncated to uint16 may land one count
    apart where its value sits on an integer."""
    kw = dict(shape=(8, 64, 600), n_spots=60, n_genes=20, n_blanks=4, seed=3)
    raw_dir = tmp_path / "raw"
    write_raw_experiment(raw_dir, **kw)
    ds = jconvert.convert_data(raw_dir, tmp_path, inject_chromatic_aberration=True)
    raw = generate_raw_experiment(**kw)
    store = tconvert.convert_data(raw, inject_chromatic_aberration=True, device="cpu")
    np.testing.assert_array_equal(store.injected_chromatic_affine, jconvert.make_injection_affine())
    want = np.stack([np.asarray(ds.load_local_corrected_image(tile=0, bit=b)) for b in range(16)])
    got = np.stack([store.corrected[(0, b)] for b in range(16)])
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.9999
    # the reference wavelength's bits are stored as they were rendered
    np.testing.assert_array_equal(got[0::2], raw.bits[0, 0::2])
    assert not np.array_equal(got[1], raw.bits[0, 1])


# --------------------------------------------------------- bead calibration
def _bead_volumes(true_affine, seed=3, shape=(16, 96, 96), spacing=(0.31, 0.098, 0.098), counts=False):
    """tests/test_utils_misc.py's bead pair: 40 beads, the second channel's
    beads at inv(A) of the reference channel's, with unit Gaussian noise;
    with ``counts``, Poisson counts over a background of 40 instead (the
    noise model RLGC assumes)."""
    rng = np.random.default_rng(seed)
    spacing = np.asarray(spacing)
    beads_um = np.column_stack([rng.uniform(2, 14, 40) * spacing[0], rng.uniform(10, 86, 40) * spacing[1],
                                rng.uniform(10, 86, 40) * spacing[2]])

    def render(points_um):
        vol = np.zeros(shape, np.float32)
        zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape], indexing="ij")
        for p in points_um:
            c = p / spacing
            vol += (800 * np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                                 / (2 * 1.2**2))).astype(np.float32)
        if counts:
            return rng.poisson(vol.astype(np.float64) + 40).astype(np.float32)
        return vol + rng.normal(0, 1, shape).astype(np.float32)

    ref_vol = render(beads_um)
    return ref_vol, render(_transform(np.linalg.inv(true_affine), beads_um)), spacing


def _full_affine():
    """A full 3-D affine: translations, scale and shear."""
    a = np.eye(4)
    a[:3, 3] = (0.12, 0.3, -0.2)
    a[1, 1], a[2, 2], a[1, 2], a[2, 1] = 0.998, 0.9985, 0.002, -0.0015
    return a


@pytest.mark.parametrize("kind", ["translation", "full"])
def test_bead_calibration_matches_reference(kind):
    """Without deconvolution: identical centroids, matches and affines."""
    true_affine = np.eye(4)
    true_affine[1, 3], true_affine[2, 3] = 0.3, -0.2
    if kind == "full":
        true_affine = _full_affine()
    ref_vol, ch2_vol, spacing = _bead_volumes(true_affine)
    for vol in (ref_vol, ch2_vol):
        np.testing.assert_array_equal(tbead.detect_beads(vol, device="cpu"), jbead.detect_beads(vol))
    want = jbead.estimate_chromatic_affines([ref_vol, ch2_vol], [0.52, 0.67], voxel_size_zyx_um=spacing)
    got = tbead.estimate_chromatic_affines([ref_vol, ch2_vol], [0.52, 0.67], voxel_size_zyx_um=spacing,
                                           device="cpu")
    assert _payload(got) == _payload(want)
    est = np.asarray(got["channels"]["wavelength_0.670000"]["affine_zyx_um"])
    np.testing.assert_allclose(est[:3, 3], true_affine[:3, 3], atol=0.08)
    table = tbead.detect_bead_centroids(ch2_vol, max_beads=30, device="cpu")
    frame = jbead.detect_bead_centroids(ch2_vol, max_beads=30)
    for col in frame.columns:
        np.testing.assert_array_equal(table[col], frame[col].to_numpy(), err_msg=col)


def test_mutual_nn_and_fit_match_reference():
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 100, (50, 3))
    tgt = np.concatenate([src[:45] + [0.5, -0.3, 0.2], rng.uniform(0, 100, (5, 3))])
    for max_distance in (2.0, 0.1):
        for a, b in zip(tbead.mutual_nearest_neighbors(src, tgt, max_distance),
                        jbead.mutual_nearest_neighbors(src, tgt, max_distance)):
            np.testing.assert_array_equal(a, b)
    s, t = tbead.mutual_nearest_neighbors(src, tgt, 2.0)
    got, gdiag = tbead.fit_affine_source_to_reference(s, t)
    want, wdiag = jbead.fit_affine_source_to_reference(s, t)
    np.testing.assert_array_equal(got, want)
    assert gdiag == wdiag


def test_bead_calibration_with_deconvolution_near_reference():
    """run_chromatic_calibration with RLGC (vectorial PSFs, 30 iterations)
    on bead counts: torch's splits differ from threefry's, so the
    translations are held within 0.02 µm of the reference's, and the
    linear part within 0.01."""
    true_affine = _full_affine()
    ref_vol, ch2_vol, spacing = _bead_volumes(true_affine, counts=True)

    class _RefStore:
        voxel_size_zyx_um = spacing
        na, ri = 1.35, 1.4
        calibration = None

        def save_chromatic_affine_transforms_zyx_um(self, calibration):
            self.calibration = calibration

    _, port = _stores()
    port.voxel_size_zyx_um = spacing
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the missing U-FISH checkpoint's DoG fallback
        want = jbead.run_chromatic_calibration(_RefStore(), [ref_vol, ch2_vol], [0.52, 0.67])
        got = tbead.run_chromatic_calibration(port, [ref_vol, ch2_vol], [0.52, 0.67], device="cpu")
    assert _payload(port.chromatic_calibration) == _payload(got)
    g, w = (np.asarray(c["channels"]["wavelength_0.670000"]["affine_zyx_um"]) for c in (got, want))
    assert got["channels"]["wavelength_0.670000"]["status"] == "affine_estimated"
    np.testing.assert_allclose(g[:3, 3], w[:3, 3], atol=0.02)
    np.testing.assert_allclose(g[:3, :3], w[:3, :3], atol=0.01)
    np.testing.assert_allclose(g[1:3, 3], true_affine[1:3, 3], atol=0.08)
    assert isinstance(tbead.deconvolve_channels(np.stack([ref_vol]), [np.ones((3, 3, 3)) / 27],
                                                max_iters=1, device="cpu"), torch.Tensor)
