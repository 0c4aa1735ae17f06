"""The port's deformable path against the JAX reference's, on CPU: the
generator's smooth deformation bit for bit, ``DataRegistration(
deformable_registration=True)`` on the reference's deformable case
(tests/test_registration_pipeline.py), the decode warp of every bit
through the stored flow fields, and the decoder's memo under a rewritten
flow field.

Tolerances: round transforms to 1e-6 µm (the same phase correlation on
the same input), flow fields within 0.01 px (``torch.fft`` and XLA's FFT
round differently; see tests/test_torch_flow.py), warps within
1e-5 · max (the separable flow path; see tests/test_torch_flow_warp.py).
"""

import numpy as np
import pytest
import torch

from test_registration_pipeline import _make_shifted_experiment

from merfish3d_tpu.cli.simulation import convert_simulation_to_experiment as jconvert
from merfish3d_tpu_torch.cli.simulation import convert_simulation_to_experiment as tconvert
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import make_injection_affine
from merfish3d_tpu_torch.datastore.array_store import ArrayStore
from merfish3d_tpu_torch.ops.flow import SofimaRegistrationConfig
from merfish3d_tpu_torch.pipeline import decode_warping
from merfish3d_tpu_torch.pipeline.decoder import PixelDecoder
from merfish3d_tpu_torch.pipeline.registration import DataRegistration

PIPELINE_SOFIMA = dict(patch_size_zyx=(8, 24, 24), stride_zyx=(4, 12, 12), residual_iterations=1)
FLOW_TOL_PX = 0.01


# ------------------------------------------------------------- generator
@pytest.mark.parametrize("chromatic", [False, True])
def test_deformed_generator_bit_identical(chromatic, tmp_path):
    import json

    kw = dict(shape=(6, 48, 64), n_spots=40, n_genes=12, n_blanks=3, seed=5,
              voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells", axial_sigma_um=0.44,
              tile_offset_px=(0.0, 0.0, 51.0), n_cells=8, round_shift_px=1.5, deformation_px=1.2)
    affine = make_injection_affine() if chromatic else None
    jconvert.write_raw_experiment(tmp_path, chromatic_affine_zyx_um=affine, **kw)
    raw = tconvert.generate_raw_experiment(chromatic_affine_zyx_um=affine, **kw)
    rigid = tconvert.generate_raw_experiment(chromatic_affine_zyx_um=affine, **{**kw, "deformation_px": 0.0})
    for b in range(16):
        np.testing.assert_array_equal(raw.bits[0, b], np.load(tmp_path / "tile0000" / f"bit{b + 1:03d}.npy"))
    for r in range(8):
        np.testing.assert_array_equal(raw.fiducial[0, r],
                                      np.load(tmp_path / "tile0000" / f"fiducial_round{r + 1:03d}.npy"))
    truth = json.loads((tmp_path / "GT_misregistration.json").read_text())
    assert raw.deformation_px == truth["deformation_px"] == 1.2
    np.testing.assert_array_equal(raw.round_shifts_px_zyx, truth["round_shifts_px_zyx"])
    # the deformation moves the moving rounds only (the later images draw
    # other Poisson noise: the sampler's draws depend on the rates)
    np.testing.assert_array_equal(raw.fiducial[0, 0], rigid.fiducial[0, 0])
    assert not np.array_equal(raw.fiducial[0, 3], rigid.fiducial[0, 3])
    assert rigid.deformation_px == 0.0


# ---------------------------------------------------------- registration
@pytest.fixture(scope="module")
def deformable_case(tmp_path_factory):
    """The reference's deformable pipeline case, registered by both
    packages: (reference datastore, port store)."""
    from merfish3d_tpu.ops.flow import SofimaRegistrationConfig as JConfig
    from merfish3d_tpu.pipeline.registration import DataRegistration as JRegistration

    ds, _ = _make_shifted_experiment(tmp_path_factory.mktemp("deformable"), shift_px=(0.0, 2.0, -3.0))
    reg = JRegistration(ds, decon_fiducial=False, decon_readout=False, deformable_registration=True,
                        global_registration=False, verbose=0)
    reg._sofima_config = JConfig(**PIPELINE_SOFIMA)
    reg.register_one_tile(0)
    n_bits = 4
    store = ArrayStore.from_arrays(
        gene_ids=["g1", "g2"],
        codebook_matrix=np.asarray([[1, 1, 1, 1], [0, 0, 0, 0]]),
        voxel_size_zyx_um=ds.voxel_size_zyx_um,
        round_of_bit=[ds.load_local_round_linker(tile=0, bit=b) - 1 for b in range(n_bits)],
        bit_wavelengths_um=[ds.load_local_wavelengths_um(tile=0, bit=b) for b in range(n_bits)],
        stage_positions_zyx_um=np.zeros(3),
        corrected=np.stack([np.asarray(ds.load_local_corrected_image(tile=0, bit=b)) for b in range(n_bits)])[None],
        fiducial_corrected=np.stack([np.asarray(ds.load_local_corrected_image(tile=0, round=r))
                                     for r in range(2)])[None],
    )
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False, ufish_model="dog",
                     deformable_registration=True,
                     sofima_config=SofimaRegistrationConfig(**PIPELINE_SOFIMA)).register_all_tiles()
    return ds, store


def test_deformable_registration_matches_reference(deformable_case):
    ds, store = deformable_case
    np.testing.assert_allclose(store.round_transforms[(0, 1)], ds.load_local_round_transform_zyx_um(0, 1),
                               rtol=0, atol=1e-6)
    want, want_attrs = ds.load_local_sofima_flow_field(0, 1)
    got, got_attrs = store.load_local_sofima_flow_field(0, 1)
    assert list(store.flow_fields) == [(0, 1)]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL_PX)
    assert got_attrs == {k: want_attrs[k] for k in got_attrs}
    assert got_attrs["sofima_status"] == "ok" and got_attrs["valid_flow_vectors"] > 0


def test_decode_warp_with_flow_matches_reference(deformable_case):
    """Every bit through the reference's stored transforms and flow field:
    the round-1 bits pass through, the round-2 bits take the flow."""
    from merfish3d_tpu.pipeline import decode_warping as jwarp

    ds, registered = deformable_case
    store = ArrayStore.from_arrays(
        gene_ids=registered.gene_ids, codebook_matrix=registered.codebook_matrix,
        voxel_size_zyx_um=registered.voxel_size_zyx_um, round_of_bit=registered.round_of_bit,
        bit_wavelengths_um=registered.bit_wavelengths_um, stage_positions_zyx_um=np.zeros(3),
        round_transforms=[[ds.load_local_round_transform_zyx_um(0, r) for r in range(2)]],
        flow_fields={(0, 1): ds.load_local_sofima_flow_field(0, 1)},
    )
    images = np.stack([np.asarray(ds.load_local_corrected_image(tile=0, bit=b), np.float32) for b in range(4)])
    want = jwarp.warp_bit_images_to_reference(
        images, datastore=ds, tile=0, bit_ids=ds.bit_ids, emission_wavelengths_um=store.bit_wavelengths_um[:, 1],
        out="host",
    )
    got = decode_warping.warp_bit_images_to_reference(torch.as_tensor(images), store=store, tile=0, bits=range(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * images.max())
    np.testing.assert_array_equal(got.numpy()[:2], images[:2])
    assert not np.array_equal(got.numpy()[2], images[2])
    for b in range(4):
        one = decode_warping.warp_bit_image_to_reference(torch.as_tensor(images[b]), store=store, tile=0, bit=b)
        np.testing.assert_allclose(one.numpy(), got.numpy()[b], rtol=0, atol=1e-5 * images.max())
        want_one = jwarp.warp_bit_image_to_reference(images[b], datastore=ds, tile=0, bit_id=ds.bit_ids[b],
                                                     emission_wavelength_um=float(store.bit_wavelengths_um[b, 1]))
        np.testing.assert_allclose(one.numpy(), want_one, rtol=0, atol=1e-5 * images.max())


def test_warped_stack_memo_follows_flow_writes(deformable_case):
    """A flow field rewritten after a decode loaded the tile's warped stack
    must not be served from the memo."""
    _, store = deformable_case
    decoder = PixelDecoder(store, device="cpu")
    first = decoder._load_warped_bit_stack(0)
    assert decoder._load_warped_bit_stack(0) is first
    field, attrs = store.load_local_sofima_flow_field(0, 1)
    try:
        store.save_local_sofima_flow_field(field + 1.5, tile=0, round=1, **attrs)
        second = decoder._load_warped_bit_stack(0)
        assert second is not first
        assert not torch.equal(second[2:], first[2:])
        torch.testing.assert_close(second[:2], first[:2], rtol=0, atol=0)
    finally:
        store.save_local_sofima_flow_field(field, tile=0, round=1, **attrs)
    torch.testing.assert_close(decoder._load_warped_bit_stack(0), first, rtol=0, atol=0)
