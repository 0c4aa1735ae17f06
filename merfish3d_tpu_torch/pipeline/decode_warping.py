"""Decode-time warp into the round-1 frame (counterpart of the affine half
of ``merfish3d_tpu/pipeline/decode_warping.py``).

Each bit's transform is ``inv(chromatic) @ round_transform``: the round's
stored registration composed with the inverse of the stored chromatic
affine of the bit's emission wavelength. A bit whose transform is the
identity passes through unchanged; every other bit is warped on the
device by :func:`..ops.warp.warp_affine_batch_device`, by class
(translation, diagonal, general), as the reference's ``out="device"``
branch does. A stored flow field needs the composed affine + flow warp,
which is not ported: it raises instead of passing the image through.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..ops.warp import warp_affine, warp_affine_batch_device


def compose_decode_warp_transform_zyx_um(*, round_transform_zyx_um, chromatic_transform_zyx_um) -> np.ndarray:
    """inv(chromatic) @ round_transform, in float32 as the reference."""
    return np.linalg.inv(np.asarray(chromatic_transform_zyx_um, dtype=np.float32)) @ np.asarray(
        round_transform_zyx_um, dtype=np.float32
    )


def bit_transform_zyx_um(store: ArrayStore, tile: int, bit: int) -> np.ndarray:
    """The composed decode transform of one bit; bits of the reference
    round take the identity round transform. Raises for a bit whose round
    has a stored flow field."""
    round_idx = int(store.round_of_bit[bit])
    if round_idx > 0 and (tile, round_idx) in store.flow_fields:
        raise NotImplementedError(
            f"tile {tile} bit {bit}: round {round_idx} has a flow field; the composed affine + "
            "flow decode warp is not ported"
        )
    round_t = np.eye(4, dtype=np.float32) if round_idx <= 0 else np.asarray(
        store.round_transform(tile, round_idx), np.float32
    )
    return compose_decode_warp_transform_zyx_um(
        round_transform_zyx_um=round_t,
        chromatic_transform_zyx_um=store.chromatic_transform(store.bit_wavelengths_um[bit][1]),
    )


def warp_bit_images_to_reference(images: torch.Tensor, *, store: ArrayStore, tile: int, bits) -> torch.Tensor:
    """(B, Z, Y, X) native bit images → the same images in the round-1
    frame, on their device."""
    transforms = np.stack([bit_transform_zyx_um(store, tile, b) for b in bits])
    eye = np.eye(4, dtype=np.float32)
    sel = np.flatnonzero([not np.allclose(t, eye) for t in transforms])
    if sel.size == 0:
        return images
    idx = torch.as_tensor(sel, device=images.device)
    out = images.clone()
    out[idx] = warp_affine_batch_device(images[idx], transforms[sel], store.voxel_size_zyx_um)
    return out


def warp_bit_image_to_reference(image: torch.Tensor, *, store: ArrayStore, tile: int, bit: int) -> torch.Tensor:
    """One native bit image into the round-1 frame (float32, on its
    device), short-circuiting an identity transform."""
    transform = bit_transform_zyx_um(store, tile, bit)
    if np.allclose(transform, np.eye(4, dtype=np.float32)):
        return image.to(torch.float32)
    return warp_affine(image, transform_zyx_um=transform, spacing_zyx_um=store.voxel_size_zyx_um,
                       reference_shape=tuple(image.shape))
