"""Where an entry point's input goes."""

from __future__ import annotations

import torch


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``. With no device given, a tensor
    keeps its own and anything else goes to the card: entry points run on
    CUDA unless the caller asks for the CPU."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return torch.as_tensor(x, device=device)
