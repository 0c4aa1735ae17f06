"""The check's own proof: the timed path broken underneath, and the
control in the program's place, each make ``correct`` come out false.
Small tiles on the CPU; the harness's look for a card is skipped."""

import time

import pytest

from benchmark import harness
from benchmark.calibrate import readings
from benchmark.faults import FAULTS
from benchmark.tests import SMALL, TINY

SEED = 2**31 + 21


def run(cell: str, size: dict = SMALL) -> dict:
    return harness.run_cell(cell, SEED, 0.1, False, t_start=time.perf_counter(), device="cpu",
                            config_override=size)


def failed(result: dict) -> set:
    return {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}


def test_sound_run_is_correct():
    assert run("prod_rigid-nodecon")["correct"] is True


@pytest.mark.parametrize("fault, cell, number, size", [
    ("registration_unchanged", "prod_rigid-nodecon", "shift_px", SMALL),
    ("rlgc_unchanged", "prod_rigid-decon", "decon_l2", SMALL),
    ("fiducial_rlgc_unchanged", "prod_rigid-fiddecon", "fid_decon_l2", TINY),
    ("half_the_bits", "prod_rigid-nodecon", "table_miss", SMALL),
    ("altered_answer", "prod_rigid-nodecon", "gene_swaps", SMALL),
])
def test_a_planted_fault_is_not_correct(fault, cell, number, size):
    """A step that returns its state unchanged (registration, the readout
    RLGC, the fiducial RLGC); half of the bit stack replaced by the other
    half's mean; one answer given another gene where it is produced."""
    with FAULTS[fault]():
        result = run(cell, size)
    assert result["correct"] is False and number in failed(result)


@pytest.mark.parametrize("cell, size", [("prod_rigid-nodecon", SMALL), ("prod_rigid-decon", SMALL),
                                        ("prod_rigid-fiddecon", TINY)])
def test_control_fails_a_limit(cell, size):
    """The reference in bfloat16 (TF32 matmuls) in the program's place."""
    limits = harness.load_cell(cell)[1]["limits"]
    (control,) = readings(cell, [], [SEED], device="cpu", config_override=size)
    assert any(v > limits[k] for k, v in control["gaps"].items())
