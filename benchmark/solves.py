"""The span both RLGC metrics read: every readout solve the registration
runs (``rlgc_batch`` as it calls it), synchronized, with each volume's
iteration count (``return_iters``) and the padded shape of the solve."""

import numpy as np

from .reference.fftutils import padded_shape

SPAN = ("rlgc", "merfish3d_tpu_torch.pipeline.registration", "rlgc_batch")


def solve(inner, args, kwargs):
    out, iters = inner(*args, return_iters=True, **kwargs)
    return out, (list(iters), padded_shape(tuple(args[0].shape[1:]), np.shape(args[1])))


def install(spans):
    spans.wrap(*SPAN, call=solve)
