"""The port's hermetic chain with the repo's trained c8 U-FISH CNN on
uniform-0.315um-nodecon, on CPU, against the reference's chain on the same
case: the CNN pin and the stored u8 probability maps. A file of its own
(the reference chain and the port's take minutes on CPU) so that the test
runner's per-file scheduling can place it beside the other slow port
tests.
"""

import numpy as np
import pytest
from f1_matrix_common import MatrixCase
from torch_port_common import CNN_CHECKPOINT, CNN_PINS, DOG_PINS, F1_TOLERANCE, port_chain, reference_state


@pytest.fixture(scope="module")
def reference_cnn(tmp_path_factory):
    """The reference chain on uniform-0.315um-nodecon with the c8 CNN."""
    return reference_state(tmp_path_factory.mktemp("reference-cnn"), MatrixCase("uniform", 0.315, False),
                           ufish_checkpoint=CNN_CHECKPOINT)


def test_cnn_slice_uniform_matches_reference(reference_cnn):
    """The port's chain with the c8 CNN meets the reference's CNN pin; its
    u8 probability maps match the reference datastore's: at most 1 % of
    the voxels more than one count apart (the reference's default
    predictor runs BatchNorm in bf16, see
    tests/test_torch_ufish.py::test_predictor_matches_reference)."""
    store, f1 = port_chain("uniform", False, cnn=True)
    assert abs(f1 - CNN_PINS["uniform"]) <= F1_TOLERANCE and f1 >= DOG_PINS["uniform"] - F1_TOLERANCE, f1
    assert abs(reference_cnn["f1"]["f1"] - CNN_PINS["uniform"]) <= F1_TOLERANCE
    got = np.stack([store.feature_predictor[(0, b)] for b in range(16)])
    want = reference_cnn["probability_u8"]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    far = np.abs(got.astype(np.int16) - want.astype(np.int16)) > 1
    assert far.mean() <= 0.01, far.mean()
