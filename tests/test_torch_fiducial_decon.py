"""Fiducial deconvolution (``decon_fiducial=True``, the default of the port,
of the reference and of the verify drive) held to the reference, on CPU.

One hermetic store whose fiducial rounds carry known rigid shifts (the
production renderer, up to 2 px) is registered with fiducial RLGC and no
readout decon twice: by the reference's ``DataRegistration`` (JAX on the
CPU, its datastore on disk) and by the port's (CPU torch, in-memory
store), with the same ``decon_max_iters``. RLGC's binomial splits come
from different generators in the two packages (threefry against
``torch.Generator``), so the deconvolved rounds differ by sampling noise
and exact equality is not expected: every round transform is held to the
reference's within one 0.1 px step of the phase correlation's refinement
grid (upsample factor 10), and to the injected shift within 0.3 px.
"""

import numpy as np
import pytest

from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
    generate_raw_experiment,
)
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.pipeline.registration import DataRegistration

GRID_STEP = 0.1  # one step of the upsample_factor=10 refinement grid
SHIFT_TOL_PX = 0.3  # recovered vs injected (merfish3d_tpu/utils/production_case.py)
DECON_ITERS = 6
RAW = dict(shape=(12, 96, 128), n_spots=60, n_genes=12, n_blanks=3, seed=7,
           voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="uniform",
           axial_sigma_um=0.44, tile_offset_px=(0.0, 0.0, 51.0), round_shift_px=2.0)


@pytest.fixture(scope="module")
def transforms(tmp_path_factory):
    """(reference transforms, port transforms, injected px shifts, spacing)."""
    from merfish3d_tpu.cli.simulation import convert_to_datastore as sim_datastore
    from merfish3d_tpu.cli.simulation.convert_simulation_to_experiment import write_raw_experiment
    from merfish3d_tpu.pipeline.registration import DataRegistration as ReferenceRegistration

    work = tmp_path_factory.mktemp("fiducial-decon")
    write_raw_experiment(work / "raw", **RAW)
    ds = sim_datastore.convert_data(work / "raw", work)
    ReferenceRegistration(ds, decon_fiducial=True, decon_readout=False, decon_max_iters=DECON_ITERS,
                          global_registration=False, ufish_model="dog",
                          verbose=0)._generate_registrations(0)
    raw = generate_raw_experiment(**RAW)
    want = np.stack([ds.load_local_round_transform_zyx_um(tile=0, round=r)
                     for r in range(raw.fiducial.shape[1])])
    store = convert_data(raw)
    DataRegistration(store, device="cpu", decon_fiducial=True, decon_readout=False,
                     decon_max_iters=DECON_ITERS, ufish_model="dog")._generate_registrations(0)
    got = np.stack([store.round_transforms[(0, r)] for r in range(raw.fiducial.shape[1])])
    return want, got, raw.round_shifts_px_zyx, np.asarray(RAW["voxel_size_zyx_um"])


def test_fiducial_decon_transforms_match_reference(transforms):
    want, got, _, spacing = transforms
    for r in range(len(want)):
        np.testing.assert_array_equal(got[r][:3, :3], np.eye(3))
        np.testing.assert_array_equal(want[r][:3, :3], np.eye(3))
        delta = np.abs(got[r][:3, 3] - want[r][:3, 3]) / spacing
        assert delta.max() <= GRID_STEP + 1e-4, (r, got[r][:3, 3] / spacing, want[r][:3, 3] / spacing)


def test_fiducial_decon_recovers_injected_shifts(transforms):
    want, got, injected, spacing = transforms
    assert np.abs(injected).max() > 0.5
    for t in (want, got):
        assert np.abs(t[:, :3, 3] / spacing - injected).max() <= SHIFT_TOL_PX
