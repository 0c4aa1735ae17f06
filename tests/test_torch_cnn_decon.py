"""The port's hermetic chain on cells-0.315um-decon with RLGC on the
readout bits and the repo's trained c8 U-FISH CNN, on CPU, held to the
reference's CNN pin. A file of its own so that the test runner's per-file
scheduling can place it beside the other slow port tests.
"""

import numpy as np
from torch_port_common import CNN_PINS, DOG_PINS, F1_TOLERANCE, port_chain


def test_cnn_slice_cells_decon_meets_pin():
    """cells-0.315um-decon with RLGC on the readout bits and the c8 CNN."""
    store, f1 = port_chain("cells", True, cnn=True)
    assert abs(f1 - CNN_PINS["cells"]) <= F1_TOLERANCE and f1 >= DOG_PINS["cells"] - F1_TOLERANCE, f1
    assert not np.array_equal(store.registered[(0, 0)], store.corrected[(0, 0)])
