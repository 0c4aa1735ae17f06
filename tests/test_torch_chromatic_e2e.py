"""Chromatic aberration end to end through the port, against the reference,
on CPU: the input of the reference's ``test_chromatic_injection_recovery``
((10, 128, 128), 120 spots, seed 3; injection (0.15, 1.0, 0.3, -0.25) at
conversion; identity registration), decoded with the chromatic estimate on
by both packages. The port renders its own raw data (bit-identical) and
injects through its own warp, so the stored bits may differ by one count
where a warped value sits on an integer.
"""

import numpy as np
import pandas as pd
import pytest

from merfish3d_tpu_torch.cli.simulation import convert_to_datastore as tconvert
from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
    generate_raw_experiment,
)
from merfish3d_tpu_torch.pipeline.decoder import PixelDecoder

RAW = dict(shape=(10, 128, 128), n_spots=120, n_genes=20, n_blanks=4, seed=3)
INJECTION = dict(z_shift_um=0.15, yx_scale=1.0, y_shift_um=0.3, x_shift_um=-0.25)
DECODER = dict(minimum_pixels=4, magnitude_threshold=(0.9, 10.0), estimate_chromatic_affines=True)


def _non_reference(calibration: dict) -> dict:
    (channel,) = [c for c in calibration["channels"].values() if not c.get("reference_channel")]
    return channel


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's test_chromatic_injection_recovery run."""
    from merfish3d_tpu.cli.simulation import convert_simulation_to_experiment as sim_convert
    from merfish3d_tpu.cli.simulation import convert_to_datastore as sim_datastore
    from merfish3d_tpu.cli.simulation.calculate_f1 import match_spots_f1 as ref_f1
    from merfish3d_tpu.pipeline.decoder import PixelDecoder as RefDecoder

    root = tmp_path_factory.mktemp("chromatic")
    sim_convert.write_raw_experiment(root / "raw", **RAW)
    ds = sim_datastore.convert_data(root / "raw", root, inject_chromatic_aberration=True,
                                    injection_affine=sim_datastore.make_injection_affine(**INJECTION))
    for b in range(ds.num_bits):
        img = ds.load_local_corrected_image(tile=0, bit=b)
        ds.save_local_registered_image(img, tile=0, bit=b)
        ds.save_local_feature_predictor_image(np.ones(np.asarray(img).shape, np.float32), tile=0, bit=b)
    for r in range(ds.num_rounds):
        img = ds.load_local_corrected_image(tile=0, round=r)
        ds.save_local_registered_image(img, tile=0, round=r)
        ds.save_local_round_transform_zyx_um(np.eye(4), tile=0, round=r)
    decoder = RefDecoder(ds, verbose=0, **DECODER)
    decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=3)
    channel = _non_reference(ds.load_chromatic_affine_transforms_zyx_um())
    table = decoder.decode_all_tiles(filter_method="blank_fraction")
    f1 = ref_f1(table, pd.read_csv(root / "raw" / "GT_spots.csv"), radius_um=1.0)
    return {"channel": channel, "f1": f1["f1"]}


@pytest.fixture(scope="module")
def port():
    """The port's chain on the same input, on CPU."""
    raw = generate_raw_experiment(**RAW)
    store = tconvert.convert_data(raw, inject_chromatic_aberration=True, device="cpu",
                                  injection_affine=tconvert.make_injection_affine(**INJECTION))
    for b in range(store.num_bits):
        store.registered[(0, b)] = store.corrected[(0, b)]
        store.feature_predictor[(0, b)] = np.full(raw.bits.shape[2:], 255, np.uint8)
    for r in range(store.num_rounds):
        store.round_transforms[(0, r)] = np.eye(4)
    decoder = PixelDecoder(store, device="cpu", **DECODER)
    decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=3)
    channel = _non_reference(store.load_chromatic_affine_transforms_zyx_um())
    table = decoder.decode_all_tiles(filter_method="blank_fraction")
    f1 = match_spots_f1(table, raw.ground_truth, radius_um=1.0)
    return {"channel": channel, "f1": f1["f1"], "store": store, "table": table}


def test_chromatic_status_matches_reference(reference, port):
    assert port["channel"]["status"] == reference["channel"]["status"] == "affine_estimated"
    table = port["store"].iteration_checkpoints[2][0]
    assert {f"bit{b:02d}_center_{a}" for b in range(1, 17) for a in "zyx"} <= set(table)


def test_chromatic_affine_near_reference_and_injection(reference, port):
    got = np.asarray(port["channel"]["affine_zyx_um"])
    want = np.asarray(reference["channel"]["affine_zyx_um"])
    injection = tconvert.make_injection_affine(**INJECTION)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=0.02)
    np.testing.assert_allclose(got[:3, 3], injection[:3, 3], atol=0.12)


def test_chromatic_f1_matches_reference(reference, port):
    assert abs(port["f1"] - reference["f1"]) <= 0.01
    assert port["f1"] >= 0.8
    # the final decode ran without the centroid columns
    assert "bit01_center_z" not in port["table"]
