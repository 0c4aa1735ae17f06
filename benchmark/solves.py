"""The span both RLGC metrics read: every batch solve the registration
runs (``rlgc_batch`` as it calls it), synchronized, with each volume's
iteration count (``return_iters``) and the padded shape of the solve.

That is every readout solve of a tile, and with fiducial deconvolution
also the moving rounds' batch solves (two a production tile: rounds 1–4
and 5–7). A single-volume solve goes through ``chunked_rlgc`` and lies
outside the span: round 0's fiducial solve, and any round or bit the
registration solves alone (a batch of one, or y above its batch limit)."""

import numpy as np

from .reference.fftutils import padded_shape

SPAN = ("rlgc", "merfish3d_tpu_torch.pipeline.registration", "rlgc_batch")


def solve(inner, args, kwargs):
    out, iters = inner(*args, return_iters=True, **kwargs)
    return out, (list(iters), padded_shape(tuple(args[0].shape[1:]), np.shape(args[1])))


def install(spans):
    spans.wrap(*SPAN, call=solve)
