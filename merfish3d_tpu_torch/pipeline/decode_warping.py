"""Decode-time warp into the round-1 frame (counterpart of
``merfish3d_tpu/pipeline/decode_warping.py``).

Each bit's transform is ``inv(chromatic) @ round_transform``: the round's
stored registration composed with the inverse of the stored chromatic
affine of the bit's emission wavelength. A bit whose round has a stored
flow field is warped by the composed affine + flow warp
(:func:`..ops.warp.warp_affine_plus_flow_batch_device`), an identity
affine included; of the other bits, one whose transform is the identity
passes through unchanged, and every other one is warped on the device by
:func:`..ops.warp.warp_affine_batch_device`, by class (translation,
diagonal, general), as the reference's ``out="device"`` branch does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..ops.warp import (
    warp_affine,
    warp_affine_batch_device,
    warp_affine_plus_flow,
    warp_affine_plus_flow_batch_device,
)
from ..utils.profiling import to_device


def compose_decode_warp_transform_zyx_um(*, round_transform_zyx_um, chromatic_transform_zyx_um) -> np.ndarray:
    """inv(chromatic) @ round_transform, in float32 as the reference."""
    return np.linalg.inv(np.asarray(chromatic_transform_zyx_um, dtype=np.float32)) @ np.asarray(
        round_transform_zyx_um, dtype=np.float32
    )


def bit_transform_zyx_um(store: ArrayStore, tile: int, bit: int) -> np.ndarray:
    """The composed decode transform of one bit; bits of the reference
    round take the identity round transform."""
    round_idx = int(store.round_of_bit[bit])
    round_t = np.eye(4, dtype=np.float32) if round_idx <= 0 else np.asarray(
        store.round_transform(tile, round_idx), np.float32
    )
    return compose_decode_warp_transform_zyx_um(
        round_transform_zyx_um=round_t,
        chromatic_transform_zyx_um=store.chromatic_transform(store.bit_wavelengths_um[bit][1]),
    )


def bit_flow_field(store: ArrayStore, tile: int, bit: int):
    """(field, attrs) of the bit's round, or None for the reference round
    and for a round without one."""
    round_idx = int(store.round_of_bit[bit])
    return None if round_idx <= 0 else store.load_local_sofima_flow_field(tile, round_idx)


def warp_image_with_sofima_metadata(image, *, transform_zyx_um, spacing_zyx_um, sofima_flow_field_xyz_px,
                                    flow_attrs, reference_shape=None) -> torch.Tensor:
    """Composed affine + flow warp from a stored flow field's attributes;
    the reference shape defaults to the one they record."""
    if reference_shape is None:
        reference_shape = flow_attrs["reference_shape_zyx_px"]
    return warp_affine_plus_flow(
        image,
        sofima_flow_field_xyz_px,
        transform_zyx_um=transform_zyx_um,
        spacing_zyx_um=spacing_zyx_um,
        reference_shape=tuple(int(v) for v in reference_shape),
        map_stride_zyx_px=flow_attrs["map_stride_zyx_px"],
        map_box_start_xyz_px=flow_attrs["map_box_start_xyz_px"],
    )


def warp_bit_images_to_reference(images: torch.Tensor, *, store: ArrayStore, tile: int, bits) -> torch.Tensor:
    """(B, Z, Y, X) native bit images → the same images in the round-1
    frame, on their device: the bits with a flow field in one composed
    batch, the others by affine class."""
    bits = list(bits)
    transforms = np.stack([bit_transform_zyx_um(store, tile, b) for b in bits])
    flows = [bit_flow_field(store, tile, b) for b in bits]
    eye = np.eye(4, dtype=np.float32)
    with_flow = np.flatnonzero([f is not None for f in flows])
    affine_only = np.flatnonzero([f is None and not np.allclose(t, eye) for f, t in zip(flows, transforms)])
    if with_flow.size == 0 and affine_only.size == 0:
        return images
    out = images.clone()
    spacing = store.voxel_size_zyx_um
    if affine_only.size:
        idx = to_device(affine_only, images.device)
        out[idx] = warp_affine_batch_device(images[idx], transforms[affine_only], spacing)
    if with_flow.size:
        idx = to_device(with_flow, images.device)
        sel = [flows[i] for i in with_flow]
        out[idx] = warp_affine_plus_flow_batch_device(
            images[idx],
            np.stack([f for f, _ in sel]),
            transforms[with_flow],
            spacing,
            np.stack([np.asarray(a["map_stride_zyx_px"], np.float32) for _, a in sel]),
            np.stack([np.asarray(a["map_box_start_xyz_px"], np.float32) for _, a in sel]),
        )
    return out


def warp_bit_image_to_reference(image: torch.Tensor, *, store: ArrayStore, tile: int, bit: int) -> torch.Tensor:
    """One native bit image into the round-1 frame (float32, on its
    device): through its round's flow field where one is stored, else
    short-circuiting an identity transform."""
    transform = bit_transform_zyx_um(store, tile, bit)
    flow = bit_flow_field(store, tile, bit)
    if flow is not None:
        field, attrs = flow
        return warp_image_with_sofima_metadata(
            image, transform_zyx_um=transform, spacing_zyx_um=store.voxel_size_zyx_um,
            sofima_flow_field_xyz_px=field, flow_attrs=attrs, reference_shape=tuple(image.shape),
        )
    if np.allclose(transform, np.eye(4, dtype=np.float32)):
        return image.to(torch.float32)
    return warp_affine(image, transform_zyx_um=transform, spacing_zyx_um=store.voxel_size_zyx_um,
                       reference_shape=tuple(image.shape))
