"""The port's fiducial round registration against the JAX package, on CPU.

Phase correlation, the translate warp and staged round registration are
compared on bead fields rendered from numpy seeds with known sub-pixel
shifts; the port runs its DFT kernels' plain versions, the reference its
CPU FFT. Then the port's own DataRegistration runs on the reference's
hermetic no-decon cases and is held to the round transforms the
reference stored, and the generator's round shifts to the reference's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f1_matrix_common import MatrixCase
from torch_port_common import match_rows, port_store_from_reference, reference_state, run_port_decode

from merfish3d_tpu.ops import phase_corr as jpc
from merfish3d_tpu.ops import registration as jreg
from merfish3d_tpu.ops import warp as jwarp
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
    generate_raw_experiment,
)
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.ops import phase_corr as tpc
from merfish3d_tpu_torch.ops import registration as treg
from merfish3d_tpu_torch.ops import warp as twarp
from merfish3d_tpu_torch.pipeline.registration import DataRegistration
from merfish3d_tpu_torch.utils.simulation import _render_bit_volume

SPACING = (0.315, 0.098, 0.098)
GRID_STEP = 0.1  # one step of the upsample_factor=10 refinement grid


def _bead_rounds(shape, shifts_px, seed=0, n_beads=120):
    """Poisson-noised bead fields, one per shift: round r images the beads
    at position + shifts_px[r]."""
    rng = np.random.default_rng(seed)
    beads = np.column_stack([rng.uniform(2, shape[0] - 2, n_beads),
                             rng.uniform(8, shape[1] - 8, n_beads),
                             rng.uniform(8, shape[2] - 8, n_beads)])
    amps = rng.uniform(500, 1500, n_beads)
    return np.stack([
        rng.poisson(_render_bit_volume(shape, beads + np.asarray(s), amps,
                                       sigma_zyx=(1.4, 1.4, 1.4)) + 40).astype(np.uint16)
        for s in shifts_px
    ])


SHIFTS = [(0.0, 0.0, 0.0), (0.4, 1.7, -1.3), (-0.6, -2.3, 0.8), (0.2, 5.6, 3.1)]


@pytest.fixture(scope="module")
def rounds():
    return _bead_rounds((16, 256, 256), SHIFTS)


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_phase_cross_correlation_matches_reference(rounds, upsample_factor):
    """Within one refinement-grid step of the reference, and the push
    shift undoes the injected one."""
    fixed = rounds[0].astype(np.float32)
    for r in range(1, len(SHIFTS)):
        moving = rounds[r].astype(np.float32)
        want = np.asarray(jpc.phase_cross_correlation(
            jnp.asarray(fixed), jnp.asarray(moving), upsample_factor=upsample_factor))
        got = tpc.phase_cross_correlation(
            torch.as_tensor(fixed), torch.as_tensor(moving), upsample_factor=upsample_factor
        ).numpy()
        assert np.abs(got - want).max() <= GRID_STEP + 1e-4, (r, got, want)
        # an integer peak lies within a pixel of the truth, a refined one closer
        tol = 1.0 if upsample_factor == 1 else 0.3
        assert np.abs(got + np.asarray(SHIFTS[r])).max() <= tol


def test_phase_cross_correlation_2d_and_wrap_candidates():
    """A 2D projection pair and a shift past half the window, where the
    wrap candidates decide."""
    rng = np.random.default_rng(3)
    fixed = rng.random((96, 96)).astype(np.float32)
    moving = np.roll(fixed, (-37, 12), axis=(0, 1))
    moving[:5] = 0.0  # break the circular symmetry a little
    want = np.asarray(jpc.phase_cross_correlation(jnp.asarray(fixed), jnp.asarray(moving)))
    got = tpc.phase_cross_correlation(torch.as_tensor(fixed), torch.as_tensor(moving)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (0.3, -1.7, 2.25), (-2.5, 3.0, -0.01),
                                   (7.9, -40.2, 100.0)])
def test_translate_volume_matches_reference(shift):
    rng = np.random.default_rng(1)
    vol = (rng.random((6, 20, 24)) * 1000).astype(np.float32)
    want = np.asarray(jwarp.translate_volume(jnp.asarray(vol), jnp.asarray(shift, jnp.float32)))
    got = twarp.translate_volume(torch.as_tensor(vol), torch.as_tensor(shift)).numpy()
    # the same two-tap blends in float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 1000)
    t = np.eye(4)
    t[:3, 3] = np.asarray(shift) * np.asarray(SPACING)
    for a, b in zip(twarp.transform_to_pixel(t, SPACING), jwarp.transform_to_pixel(t, SPACING)):
        np.testing.assert_array_equal(a, b)


def test_register_rounds_matches_reference(rounds):
    """Staged registration of three moving rounds: transforms within one
    grid step of the reference's and of the injected shifts; the warped
    fiducials within one count where the transforms agree."""
    fixed, movings = rounds[0], rounds[1:]
    want_t, want_w = jreg.register_rounds_to_fixed(
        fixed, movings, spacing_zyx_um=SPACING, return_warped=True)
    got_t, got_w = treg.register_rounds_to_fixed(
        fixed, movings, spacing_zyx_um=SPACING, return_warped=True, device="cpu")
    got_w = got_w.numpy()  # the warped rounds stay on the device
    assert got_w.dtype == np.uint16 and got_w.shape == movings.shape
    spacing = np.asarray(SPACING)
    for r in range(len(movings)):
        got_px, want_px = got_t[r, :3, 3] / spacing, want_t[r, :3, 3] / spacing
        assert np.abs(got_px - want_px).max() <= GRID_STEP + 1e-4
        assert np.abs(got_px - np.asarray(SHIFTS[r + 1])).max() <= 0.3
        np.testing.assert_array_equal(got_t[r][:3, :3], np.eye(3))
        if np.abs(got_px - want_px).max() < 1e-4:
            diff = np.abs(got_w[r].astype(np.int32) - want_w[r].astype(np.int32))
            assert diff.max() <= 1
    pair = treg.register_pair_to_fixed(fixed, movings[1], spacing_zyx_um=SPACING, device="cpu")
    np.testing.assert_array_equal(pair, got_t[1])


def test_margins_and_binning_match_reference():
    for n in (8, 48, 96, 255, 256, 1024, 2048):
        assert treg._static_margin(n) == jreg._static_margin(n)
    for spacing in (SPACING, (1.0, 0.1, 0.2), (0.1, 0.1, 0.1)):
        assert treg.registration_binning_from_spacing(spacing) == \
            jreg.registration_binning_from_spacing(spacing)


# ---------------------------------------------------------- hermetic cases
@pytest.fixture(scope="module", params=["uniform", "cells"])
def hermetic(request, tmp_path_factory):
    case = MatrixCase(request.param, 0.315, False)
    ref = reference_state(tmp_path_factory.mktemp(f"reference-{request.param}"), case)
    store = port_store_from_reference(ref)
    store.round_transforms.clear()
    store.registered.clear()
    store.feature_predictor.clear()
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False).register_all_tiles()
    return case, ref, store


def test_hermetic_round_transforms_match_reference(hermetic):
    """The port's own registration reproduces the reference's stored
    round transforms to 1e-3 px, round 2's 0.1 px x shift of
    uniform-0.315um-nodecon included. (A near-tie of the upsampled peak
    could move one 0.1 px grid step; none occurs on these cases, so none
    is allowed.)"""
    case, ref, store = hermetic
    spacing = ref["voxel_size_zyx_um"]
    for r, want in enumerate(ref["round_transforms"]):
        got = store.round_transforms[(0, r)]
        np.testing.assert_array_equal(got[:3, :3], np.eye(3))
        np.testing.assert_allclose(got[:3, 3] / spacing, want[:3, 3] / spacing, rtol=0, atol=1e-3)
    if case.distribution == "uniform":
        np.testing.assert_allclose(store.round_transforms[(0, 1)][:3, 3] / spacing,
                                   [0.0, 0.0, 0.1], atol=1e-3)
    assert not np.allclose(ref["round_transforms"][1:], np.eye(4))


def test_hermetic_fiducials_registered_as_u16(hermetic):
    _, ref, store = hermetic
    for r in range(len(ref["round_transforms"])):
        img = store.fiducial_registered[(0, r)]
        assert img.dtype == np.uint16 and img.shape == ref["raw_fiducial"][r].shape
    np.testing.assert_array_equal(store.fiducial_registered[(0, 0)], ref["raw_fiducial"][0])


def test_hermetic_decode_after_port_registration_matches_reference(hermetic):
    """Decoding on the port's own registration gives the reference's
    unfiltered decoded table, row for row within 0.01 µm."""
    case, ref, store = hermetic
    run_port_decode(store, case)
    got, want = store.decoded_tables[0], ref["decoded_table"]
    assert list(got) == list(want)
    assert len(got["gene_id"]) == len(want["gene_id"])
    assert match_rows(want, got) == 1.0


def test_registration_refuses_deconvolution():
    """Deconvolution is on by default, as in the reference, and is refused
    for a store that carries no channel PSFs."""
    store = convert_data(generate_raw_experiment(shape=(4, 16, 16), n_spots=4, seed=1))
    assert len(store.channel_psfs) == 3
    DataRegistration(store, device="cpu")
    store.channel_psfs = []
    for kw in ({"decon_readout": False}, {"decon_fiducial": False}, {}):
        with pytest.raises(ValueError, match="channel_psfs"):
            DataRegistration(store, device="cpu", **kw)
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False)


# --------------------------------------------------------------- generator
def test_generator_round_shifts_bit_identical(tmp_path):
    """The production renderer with rigid round shifts, at a small size:
    images, ground truth and the injected shifts as the reference writes
    them."""
    import pandas as pd

    from merfish3d_tpu.cli.simulation.convert_simulation_to_experiment import (
        write_raw_experiment,
    )

    kw = dict(shape=(6, 48, 64), n_spots=40, n_genes=12, n_blanks=3, seed=5,
              voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="uniform",
              axial_sigma_um=0.44, tile_offset_px=(0.0, 0.0, 51.0), round_shift_px=2.0)
    write_raw_experiment(tmp_path, **kw)
    raw = generate_raw_experiment(**kw)
    tile = tmp_path / "tile0000"
    for b in range(16):
        np.testing.assert_array_equal(raw.bits[0, b], np.load(tile / f"bit{b + 1:03d}.npy"))
    for r in range(8):
        np.testing.assert_array_equal(
            raw.fiducial[0, r], np.load(tile / f"fiducial_round{r + 1:03d}.npy"))
    truth = json.loads((tmp_path / "GT_misregistration.json").read_text())
    np.testing.assert_array_equal(raw.round_shifts_px_zyx, truth["round_shifts_px_zyx"])
    assert np.abs(raw.round_shifts_px_zyx).max() > 0.5
    gt = pd.read_csv(tmp_path / "GT_spots.csv", float_precision="round_trip")
    for col in gt.columns:
        np.testing.assert_array_equal(raw.ground_truth[col], gt[col].to_numpy(), err_msg=col)
    store = convert_data(raw)
    for r in range(8):
        np.testing.assert_array_equal(store.fiducial_corrected[(0, r)], raw.fiducial[0, r])
