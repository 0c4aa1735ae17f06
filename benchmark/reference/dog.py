"""The DoG spot predictor and the numpy-style median (frozen copies of the
program's plain versions)."""

from __future__ import annotations

import torch

from .filters import gaussian_lowpass
from .precision import q


def median_last(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Median over the trailing ``dims`` axes, averaging the two middle
    values of an even count."""
    flat = x.reshape(*x.shape[: x.ndim - dims], -1)
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def dog_probability(volume: torch.Tensor, sigma_spot: float = 1.3, sigma_bg: float = 2.6,
                    gain: float = 4.0, center: float = 5.0) -> torch.Tensor:
    """Per-plane difference of Gaussians over 1.4826 × its median absolute
    response, through a sigmoid: a [0, 1] probability of the input's shape."""
    vol = volume.to(torch.float32)
    fine = q(gaussian_lowpass(vol, sigma=(0.0, sigma_spot, sigma_spot)))
    coarse = q(gaussian_lowpass(vol, sigma=(0.0, sigma_bg, sigma_bg)))
    dog = fine - coarse
    mad = median_last(dog.abs(), dims=2)[..., None, None]
    score = dog / torch.clamp(mad * 1.4826, min=1e-6)
    return torch.sigmoid(gain * (score - center))
