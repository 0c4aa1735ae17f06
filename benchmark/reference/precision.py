"""The reference's working precision.

The configurations state float32 with TF32 off. The control computes the
same chain one step below: TF32 matmuls and convolutions, and every other
float32 stage result (spectra, RLGC state, warped and lowpassed volumes,
decode traces) rounded to bfloat16. :func:`q` is the rounding point the
modules call; it is the identity in float32.
"""

from __future__ import annotations

import contextlib

import torch

_LOW = False


def low() -> bool:
    return _LOW


def q(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back in the control, else ``t``."""
    if _LOW and t.dtype == torch.float32:
        return t.to(torch.bfloat16).to(torch.float32)
    return t


@contextlib.contextmanager
def control():
    """Run the block in the control precision."""
    global _LOW
    saved = (_LOW, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _LOW = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _LOW, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
