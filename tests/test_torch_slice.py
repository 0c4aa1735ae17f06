"""The PyTorch port's decode slice against the JAX reference chain, on CPU.

The reference runs its hermetic chain (generate → datastore → register →
decode → F1) for uniform-0.315um-nodecon once per module; its datastore's
state crosses to the port through `ArrayStore.from_arrays`, and each test
holds one stage of the port to the reference on the same inputs.
"""

import numpy as np
import pytest
import torch

from f1_matrix_common import MatrixCase
from torch_port_common import (
    SLICE_CASE,
    SLICE_PIN,
    match_rows,
    port_store_from_reference,
    reference_state,
    run_port_decode,
)

from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
    generate_raw_experiment,
)
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels
from merfish3d_tpu_torch.pipeline import decode_warping
from merfish3d_tpu_torch.pipeline.registration import DataRegistration

PINS = {"uniform": 0.9480, "cells": 0.9474}  # tests/test_f1_matrix.py


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("reference")
    state = reference_state(workdir)
    state["workdir"] = workdir
    return state


@pytest.fixture(scope="module")
def port_on_ref(ref):
    store = port_store_from_reference(ref)
    return store, run_port_decode(store)


def _gt(ref) -> dict:
    return {c: ref["ground_truth"][c].to_numpy() for c in ref["ground_truth"].columns}


def _generate(case: MatrixCase, **kw):
    return generate_raw_experiment(
        shape=(case.nz, 96, 96), n_spots=case.n_spots, n_genes=20, n_blanks=4, seed=11,
        voxel_size_zyx_um=(case.axial_step_um, 0.098, 0.098),
        distribution=case.distribution, axial_sigma_um=0.44, **kw,
    )


# ------------------------------------------------------------ generator
def test_generator_bit_identical_to_reference(ref):
    raw = _generate(SLICE_CASE)
    np.testing.assert_array_equal(raw.bits[0], ref["raw_bits"])
    np.testing.assert_array_equal(raw.fiducial[0], ref["raw_fiducial"])
    np.testing.assert_array_equal(raw.codebook, ref["codebook"])
    assert raw.gene_ids == ref["gene_ids"]
    for col, values in _gt(ref).items():
        np.testing.assert_array_equal(raw.ground_truth[col], values, err_msg=col)


@pytest.mark.parametrize("mode", ["cells", "production"])
def test_generator_modes_bit_identical(mode, tmp_path):
    """The cells distribution and the production renderer (one tile, no
    misregistration), at a small size."""
    import pandas as pd

    from merfish3d_tpu.cli.simulation.convert_simulation_to_experiment import (
        write_raw_experiment,
    )

    kw = dict(shape=(6, 48, 64), n_spots=40, n_genes=12, n_blanks=3, seed=5,
              voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells",
              axial_sigma_um=0.44)
    if mode == "production":
        kw.update(tile_offset_px=(0.0, 0.0, 51.0), n_cells=8)
    write_raw_experiment(tmp_path, **kw)
    raw = generate_raw_experiment(**kw)
    tile = tmp_path / "tile0000"
    for b in range(16):
        np.testing.assert_array_equal(raw.bits[0, b], np.load(tile / f"bit{b + 1:03d}.npy"))
    for r in range(8):
        np.testing.assert_array_equal(
            raw.fiducial[0, r], np.load(tile / f"fiducial_round{r + 1:03d}.npy")
        )
    gt = pd.read_csv(tmp_path / "GT_spots.csv", float_precision="round_trip")
    for col in gt.columns:
        np.testing.assert_array_equal(raw.ground_truth[col], gt[col].to_numpy(), err_msg=col)


# ---------------------------------------------------------- registration
def test_reference_round_transforms_are_translations_the_port_applies(ref):
    """The reference's fiducial registration of this case stores pure
    translations: identity for the reference round, sub-pixel shifts
    elsewhere (the fiducial rounds are independent Poisson draws of one
    bead field). The port's decode warp applies them as the reference
    does; only non-translation affines are left unported."""
    from merfish3d_tpu.datastore import qi2labDataStore
    from merfish3d_tpu.pipeline import decode_warping as jwarp

    transforms = ref["round_transforms"]
    np.testing.assert_array_equal(transforms[0], np.eye(4))
    for t in transforms:
        np.testing.assert_array_equal(t[:3, :3], np.eye(3))
        np.testing.assert_array_equal(t[3], [0, 0, 0, 1])
        assert np.all(np.abs(t[:3, 3] / ref["voxel_size_zyx_um"]) <= 0.5)
    rng = np.random.default_rng(0)
    images = (rng.random(ref["registered"].shape) * 100).astype(np.float32)
    ds = qi2labDataStore(ref["workdir"] / "qi2labdatastore", validate=False)
    want = jwarp.warp_bit_images_to_reference(
        images, datastore=ds, tile=0, bit_ids=ds.bit_ids,
        emission_wavelengths_um=ref["bit_wavelengths_um"][:, 1],
    )
    store = port_store_from_reference(ref)
    got = decode_warping.warp_bit_images_to_reference(
        torch.as_tensor(images), store=store, tile=0, bits=range(images.shape[0])
    ).numpy()
    # the same two-tap blends, summed in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * images.max())


def test_decode_warp_refuses_general_affine(ref, tmp_path):
    """A round transform with a rotation-like off-diagonal term, beside a
    stored chromatic calibration, is no longer refused: the port's decode
    warp applies it as the reference's ``warp_bit_images_to_reference``
    does (general class for that round's bits, diagonal for the bits
    behind the chromatic affine); with a stored flow field on that round,
    its bits take the composed affine + flow warp as the reference's do.
    Tolerance 1e-5 · max on the registered images: the general
    class's float32 coordinate sums may round one unit in the last place
    apart from XLA's contracted ones."""
    import shutil

    from merfish3d_tpu.datastore import qi2labDataStore
    from merfish3d_tpu.pipeline import decode_warping as jwarp

    shutil.copytree(ref["workdir"] / "qi2labdatastore", tmp_path / "qi2labdatastore")
    ds = qi2labDataStore(tmp_path / "qi2labdatastore", validate=False)
    store = port_store_from_reference(ref)
    rot = np.eye(4)
    rot[1, 2] = 0.01
    chromatic = np.eye(4)
    chromatic[1, 1] = chromatic[2, 2] = 0.9982
    chromatic[:3, 3] = (0.18, 0.42, -0.31)
    calibration = {"0.67": chromatic}
    ds.save_local_round_transform_zyx_um(rot, tile=0, round=3)
    ds.save_chromatic_affine_transforms_zyx_um(calibration)
    store.round_transforms[(0, 3)] = rot
    store.save_chromatic_affine_transforms_zyx_um(calibration)
    images = ref["registered"].astype(np.float32)
    want = jwarp.warp_bit_images_to_reference(
        images, datastore=ds, tile=0, bit_ids=ds.bit_ids,
        emission_wavelengths_um=ref["bit_wavelengths_um"][:, 1],
    )
    got = decode_warping.warp_bit_images_to_reference(
        torch.as_tensor(images), store=store, tile=0, bits=range(images.shape[0])
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * images.max())
    assert not np.array_equal(got[6], images[6])  # round 3's first bit moved
    one = decode_warping.warp_bit_image_to_reference(torch.as_tensor(images[7]), store=store, tile=0, bit=7)
    np.testing.assert_array_equal(one.numpy(), got[7])
    # a stored flow field on that round: its bits take the composed affine
    # + flow warp (the gather, under the general matrix), as the reference's
    field = np.random.default_rng(2).normal(0.0, 0.6, (3, 3, 8, 8)).astype(np.float32)
    attrs = dict(map_stride_zyx_px=[4.0, 12.0, 12.0], map_box_start_xyz_px=[6.0, 6.0, 2.0],
                 map_box_size_xyz_px=[85.0, 85.0, 9.0], reference_shape_zyx_px=list(images.shape[1:]),
                 moving_shape_zyx_px=list(images.shape[1:]), sofima_status="ok", valid_flow_vectors=192)
    ds.save_local_sofima_flow_field(field, tile=0, round=3, **attrs)
    store.save_local_sofima_flow_field(field, tile=0, round=3, **attrs)
    want = jwarp.warp_bit_images_to_reference(
        images, datastore=ds, tile=0, bit_ids=ds.bit_ids,
        emission_wavelengths_um=ref["bit_wavelengths_um"][:, 1],
    )
    flowed = decode_warping.warp_bit_images_to_reference(
        torch.as_tensor(images), store=store, tile=0, bits=range(images.shape[0])
    ).numpy()
    np.testing.assert_allclose(flowed, want, rtol=0, atol=1e-5 * images.max())
    assert not np.array_equal(flowed[6], got[6])  # the flow moved round 3's bits
    np.testing.assert_array_equal(np.delete(flowed, [6, 7], axis=0), np.delete(got, [6, 7], axis=0))


def test_dog_registration_matches_reference(ref):
    """u16 registered images exact; u8 spot probabilities equal on >= 99.9 %
    of voxels and never more than 1 apart (sigmoid and lowpass sums in
    another order can cross a rounding boundary of round(p * 255))."""
    store = port_store_from_reference(ref)
    store.registered.clear()
    store.feature_predictor.clear()
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False).register_all_tiles()
    registered, prob = store.registered_stack(0)
    np.testing.assert_array_equal(registered, ref["registered"])
    diff = np.abs(prob.astype(np.int16) - ref["probability_u8"].astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


# ---------------------------------------------------------------- decode
def test_normalization_vectors_match_reference(ref, port_on_ref):
    """Seeded (global) and optimized (iterative) vectors, rtol 1e-4: f32
    percentiles and medians over the same pixels."""
    store, _ = port_on_ref
    for key in ("global_vectors", "iterative_vectors"):
        run = key.split("_")[0]
        for got, want in zip(store.normalization_vectors[run], ref[key]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_decoded_table_matches_reference(ref, port_on_ref):
    """Unfiltered decoded features: same columns in order; >= 99 % of the
    reference's rows have a port row of the same gene within 0.01 µm."""
    store, _ = port_on_ref
    got, want = store.decoded_tables[0], ref["decoded_table"]
    assert list(got) == list(want)
    assert abs(len(got["gene_id"]) - len(want["gene_id"])) <= 0.01 * len(want["gene_id"])
    assert match_rows(want, got) >= 0.99


def test_f1_matches_reference(ref, port_on_ref):
    _, table = port_on_ref
    f1 = match_spots_f1(table, _gt(ref), radius_um=SLICE_CASE.match_radius_um)["f1"]
    assert abs(f1 - ref["f1"]["f1"]) <= 0.01
    assert abs(f1 - SLICE_PIN) <= 0.02
    assert list(table) == list(ref["filtered_table"])


@pytest.mark.parametrize("distribution", ["uniform", "cells"])
def test_port_chain_meets_f1_pin(distribution):
    """The port end to end on CPU: its own generator, datastore,
    DoG registration and decode."""
    case = MatrixCase(distribution, 0.315, False)
    raw = _generate(case)
    store = convert_data(raw)
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False).register_all_tiles()
    table = decode_pixels(
        store, device="cpu", minimum_pixels=case.minimum_pixels,
        magnitude_threshold=case.magnitude_threshold, lowpass_sigma=case.lowpass_sigma,
        num_tiles=1, num_iterations=2,
    )
    f1 = match_spots_f1(table, raw.ground_truth, radius_um=case.match_radius_um)["f1"]
    assert abs(f1 - PINS[distribution]) <= 0.02
    assert len(store.iteration_checkpoints) == 2


def test_array_store_checks_image_types(ref):
    from merfish3d_tpu_torch.datastore.array_store import ArrayStore

    with pytest.raises(TypeError):
        ArrayStore.from_arrays(
            gene_ids=ref["gene_ids"], codebook_matrix=ref["codebook"],
            voxel_size_zyx_um=ref["voxel_size_zyx_um"], round_of_bit=ref["round_of_bit"],
            bit_wavelengths_um=ref["bit_wavelengths_um"],
            stage_positions_zyx_um=ref["stage_zyx_um"][None],
            registered=ref["registered"][None].astype(np.float32),
        )
    store = port_store_from_reference(ref)
    del store.feature_predictor[(0, 5)]
    with pytest.raises(KeyError):
        store.registered_stack(0)
