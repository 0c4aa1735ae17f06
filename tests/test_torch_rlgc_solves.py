"""A whole RLGC solve of the port (merfish3d_tpu_torch.ops.rlgc) against
the JAX package's, on CPU, statistically: torch's generator draws other
binomial splits than threefry, so eight solves from eight seeds are held
to eight reference solves by correlation, energy and the mean iteration
count (tests/torch_port_common.solves_agree). A file of its own so that
the test runner's per-file scheduling can place it beside the other slow
port tests.
"""

import numpy as np
from torch_port_common import gaussian_psf, jax_solve, observed_counts, solves_agree

from merfish3d_tpu_torch.ops import rlgc as trlgc


def test_rlgc_statistically_matches_jax():
    obs = observed_counts(seed=2, background=2.0)
    psf = gaussian_psf()
    got, want = [], []
    for seed in range(3, 11):
        got.append(trlgc.rlgc(obs, psf, seed=seed, max_iters=30, device="cpu", return_iters=True))
        want.append(jax_solve(obs, psf, seed, 30))
    solves_agree(got, want)
    # a seed repeats its solve exactly
    np.testing.assert_array_equal(trlgc.rlgc(obs, psf, seed=3, max_iters=30, device="cpu"), got[0][0])
