"""The deformed production tile end to end through both packages, on CPU:
the reference's production smoke geometry (tests/test_production_geometry.py)
cut to one tile — (6, 192, 192), 250 spots, 40 genes + 6 blanks, seed 21,
round shifts up to 2 px, a 1.2 px smooth deformation, the production
chromatic injection at the emitter — registered with deformable flow (no
decon, DoG) and decoded with the chromatic estimate (1 optimizer
iteration, ``minimum_pixels=4``).

Tolerances: F1 within 0.01 of the reference's; every round's flow field
within 0.01 px (``torch.fft`` and XLA's FFT round differently; see
tests/test_torch_flow.py), with the reference's status and count of
valid vectors.
"""

import numpy as np
import pytest

from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import generate_raw_experiment
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data, make_injection_affine
from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels
from merfish3d_tpu_torch.pipeline.registration import DataRegistration

CASE = dict(shape=(6, 192, 192), n_spots=250, n_genes=40, n_blanks=6, seed=21)
F1_TOL = 0.01
FLOW_TOL_PX = 0.01


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from merfish3d_tpu.datastore import qi2labDataStore
    from merfish3d_tpu.utils.production_case import run_production_case

    workdir = tmp_path_factory.mktemp("deformed")
    result = run_production_case(workdir, n_tiles=1, decon=False, deformable=True, chromatic=True,
                                 num_iterations=1, minimum_pixels=4, **CASE)
    ds = qi2labDataStore(workdir / "qi2labdatastore", validate=False)
    flows = {r: ds.load_local_sofima_flow_field(0, r) for r in range(1, ds.num_rounds)}
    return {"f1": result["f1"], "flows": flows}


@pytest.fixture(scope="module")
def port():
    overlap_px = int(round(CASE["shape"][2] * 0.2))
    raw = generate_raw_experiment(
        voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells", n_cells=8, axial_sigma_um=0.44,
        tile_offset_px=(0.0, 0.0, float(CASE["shape"][2] - overlap_px)), round_shift_px=2.0, deformation_px=1.2,
        chromatic_affine_zyx_um=make_injection_affine(), **CASE,
    )
    store = convert_data(raw)
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False, ufish_model="dog",
                     deformable_registration=True).register_all_tiles()
    table = decode_pixels(store, device="cpu", minimum_pixels=4, num_tiles=1, num_iterations=1,
                          estimate_chromatic_affines=True)
    return {"f1": match_spots_f1(table, raw.ground_truth, radius_um=1.0)["f1"], "store": store}


def test_deformed_tile_flow_fields_match_reference(reference, port):
    store = port["store"]
    assert sorted(store.flow_fields) == [(0, r) for r in sorted(reference["flows"])]
    for r, (want, want_attrs) in reference["flows"].items():
        got, got_attrs = store.load_local_sofima_flow_field(0, r)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL_PX)
        assert got_attrs == {k: want_attrs[k] for k in got_attrs}
        assert got_attrs["sofima_status"] == "ok"


def test_deformed_tile_f1_matches_reference(reference, port):
    assert abs(port["f1"] - reference["f1"]) <= F1_TOL, (port["f1"], reference["f1"])
    assert port["f1"] >= 0.8
