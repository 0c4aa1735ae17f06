"""The port's own hermetic chain on cells-0.315um-decon (RLGC on the
readout bits, 12 iterations, no fiducial decon, DoG predictor) on CPU,
held to the reference's F1 pin. The uniform case stays in
tests/test_torch_rlgc.py; this one has a file of its own so that the test
runner's per-file scheduling can place it beside the other slow port
tests.
"""

import numpy as np
import pytest
from torch_port_common import DECON_PINS, F1_TOLERANCE, port_chain


@pytest.mark.parametrize("distribution", ["cells"])
def test_hermetic_decon_f1_meets_pin(distribution):
    """F1 within ±0.02 of the reference's pin."""
    store, f1 = port_chain(distribution, True)
    assert not np.array_equal(store.registered[(0, 0)], store.corrected[(0, 0)])
    assert abs(f1 - DECON_PINS[distribution]) <= F1_TOLERANCE, f1
