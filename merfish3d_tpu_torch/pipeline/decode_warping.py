"""Decode-time warp into the round-1 frame (counterpart of
``warp_bit_images_to_reference`` in
``merfish3d_tpu/pipeline/decode_warping.py``), for the two warp classes
this slice meets.

A bit whose composed transform ``inv(chromatic) @ round_transform`` is
the identity passes through unchanged. A pure translation (identity
linear part) — what fiducial registration stores for rounds that only
drifted, including the sub-pixel shifts it finds between independently
noised copies of one bead field — is applied with the reference's
separable order-1 translate (:func:`..ops.warp.translate_volume`, zero
fill). Any other affine, or a flow field, needs the general
resampler, which is not ported: it raises instead of passing the image
through.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..ops.warp import transform_to_pixel, translate_volume


def bit_transform_zyx_um(store: ArrayStore, tile: int, bit: int) -> np.ndarray:
    """inv(chromatic) @ round transform for one bit (float32); bits of the
    reference round take the identity round transform."""
    round_idx = int(store.round_of_bit[bit])
    round_t = np.eye(4, dtype=np.float32) if round_idx <= 0 else np.asarray(
        store.round_transform(tile, round_idx), np.float32
    )
    chromatic = np.asarray(
        store.chromatic_transform(store.bit_wavelengths_um[bit][1]), np.float32
    )
    return np.linalg.inv(chromatic) @ round_t


def warp_bit_images_to_reference(
    images: torch.Tensor, *, store: ArrayStore, tile: int, bits
) -> torch.Tensor:
    """(B, Z, Y, X) native bit images → the same images in the round-1
    frame. Raises ``NotImplementedError`` for a bit that needs more than a
    translation."""
    eye = np.eye(4, dtype=np.float32)
    out = images
    for i, b in enumerate(bits):
        transform = bit_transform_zyx_um(store, tile, b)
        if np.allclose(transform, eye):
            continue
        matrix, offset = transform_to_pixel(transform, store.voxel_size_zyx_um)
        diagonal = np.allclose(matrix, np.diag(np.diag(matrix)), atol=1e-8)
        if not (diagonal and np.allclose(np.diag(matrix), 1.0, atol=1e-6)):
            raise NotImplementedError(
                f"tile {tile} bit {b}: decode warp beyond a translation (affine "
                "resampling is not ported)"
            )
        if out is images:
            out = images.clone()
        out[i] = translate_volume(images[i], torch.as_tensor(offset, device=images.device))
    return out
