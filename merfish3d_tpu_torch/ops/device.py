"""Where an entry point's input goes."""

from __future__ import annotations

import torch

from ..utils.profiling import to_device


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``. With no device given, a tensor
    keeps its own and anything else goes to the card: entry points run on
    CUDA unless the caller asks for the CPU. A move to another kind of
    device is a counted upload (:func:`..utils.profiling.to_device`)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    if isinstance(x, torch.Tensor) and x.device.type == torch.device(device).type:
        return torch.as_tensor(x, device=device)
    return to_device(x, device)
