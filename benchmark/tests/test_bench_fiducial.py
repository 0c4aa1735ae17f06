"""Fiducial deconvolution in the reference: the program's solves and seeds
(round 0 alone, the moving rounds in batches), held to the program's own
stored fiducials, and the fault that skips it."""

import pytest

from benchmark import harness
from benchmark.compare import capture, registration_gaps
from benchmark.faults import FAULTS
from benchmark.generator import render_tile
from benchmark.tests import TINY

SEED = 2**31 + 5
# decon_l2's largest sound reading on the card (12 seeds a cell, PERF.md §2)
SOUND = 2.459e-3


@pytest.fixture(scope="module")
def case():
    _, workload, config = harness.load_cell("prod_rigid-fiddecon")
    workload = {**workload, "registration": {**workload["registration"], "decon_readout": False}}
    pipe = harness.Pipeline(workload, {**config, **TINY}, "cpu")
    tile = render_tile(pipe.config, SEED, 0, "cpu")
    return pipe, tile, capture(pipe.reference_registration(tile))


def program_registration(pipe, tile):
    store = pipe.convert.convert_data(tile, device="cpu")
    pipe.registration.DataRegistration(store, device="cpu", **pipe.program_registration_options()).register_all_tiles()
    return capture(store)


def test_the_reference_deconvolves_the_fiducials_as_the_program_does(case):
    pipe, tile, want = case
    gaps = registration_gaps(program_registration(pipe, tile), want, tile, decon=False, flow=False, fid_decon=True)
    assert gaps["shift_px"] == 0.0 and gaps["fid_decon_l2"] <= SOUND, gaps
    # every round's stored fiducial differs from its raw counts: the solves ran
    for r in range(len(tile.round_shifts_px_zyx)):
        assert (want.fiducials[r] != tile.fiducial[0, r]).mean() > 0.5


def test_unchanged_fiducial_solves_fail_fid_decon_l2(case):
    pipe, tile, want = case
    limit = harness.load_cell("prod_rigid-fiddecon")[1]["limits"]["fid_decon_l2"]
    with FAULTS["fiducial_rlgc_unchanged"]():
        got = program_registration(pipe, tile)
    assert registration_gaps(got, want, tile, decon=False, flow=False, fid_decon=True)["fid_decon_l2"] > limit
