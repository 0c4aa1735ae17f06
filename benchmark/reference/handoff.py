"""Register → decode handoff forms (counterpart of ``_to_cache_forms`` and
``_product_f32`` in ``merfish3d_tpu/pipeline/handoff.py``).

The readout intermediates are kept as the datastore persists them: the
decon volume as uint16 and the spot probability quantized to k/255 in
uint8. The decoder's input is their product in float32.
"""

from __future__ import annotations

import torch


def to_cache_forms(decons_f32: torch.Tensor, probs: torch.Tensor):
    """(decon f32, prob) → (decon u16, prob u8). ``torch.round`` rounds
    half to even, as numpy and jnp do."""
    du = torch.clamp(decons_f32, 0.0, 65535.0).to(torch.int32).to(torch.uint16)
    pu = torch.clamp(torch.round(probs.to(torch.float32) * 255.0), 0.0, 255.0)
    return du, pu.to(torch.uint8)


def product_f32(decon_u16: torch.Tensor, prob_u8: torch.Tensor) -> torch.Tensor:
    """Decode input: decon × (prob / 255) in float32."""
    return decon_u16.to(torch.float32) * (prob_u8.to(torch.float32) / 255.0)
