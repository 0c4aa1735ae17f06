"""Raw acquisition → datastore (counterpart of
``merfish3d_tpu/cli/simulation/convert_to_datastore.py``), into an
in-memory :class:`ArrayStore`, with the reference's channel PSFs and its
optional synthetic chromatic-aberration injection: every bit of a
non-reference emission wavelength is warped by a known chromatic affine
before it is stored, so the decode-time estimator can be held to it."""

from __future__ import annotations

import numpy as np
import torch

from ...datastore.array_store import ArrayStore
from ...models.psf import make_channel_psfs
from ...ops.warp import warp_affine
from ...utils import profiling
from .convert_simulation_to_experiment import RawExperiment


def make_injection_affine(
    z_shift_um: float = 0.18,
    yx_scale: float = 0.9982,
    y_shift_um: float = 0.42,
    x_shift_um: float = -0.31,
) -> np.ndarray:
    """The reference's injected chromatic affine (µm, reference → moving)."""
    affine = np.eye(4)
    affine[0, 3] = z_shift_um
    affine[1, 1] = yx_scale
    affine[1, 3] = y_shift_um
    affine[2, 2] = yx_scale
    affine[2, 3] = x_shift_um
    return affine


def convert_data(
    raw: RawExperiment,
    *,
    inject_chromatic_aberration: bool = False,
    injection_affine=None,
    device="cuda",
) -> ArrayStore:
    """Readout bits (uint16, as :class:`RawExperiment` holds them) become
    the store's corrected images; fiducial rounds become its corrected
    fiducial images. uint16 already lies in the range the reference clips
    to, so the bits are stored as read-only views of ``raw.bits``, with no
    pass over the values (counted by ``datastore.clip.passthrough``, once
    an image); with injection they are stored as one private, writable
    copy instead. Bits of another dtype are refused (``TypeError``).

    The store holds views of ``raw.bits`` (without injection) and of
    ``raw.fiducial``: the caller must not write to those arrays while the
    store is in use. The channel PSFs are the reference's:
    Gaussian, (15, 15, 15), at the fiducial emission wavelength and then
    at each readout emission wavelength in order.

    With ``inject_chromatic_aberration`` (``injection_affine`` defaults to
    :func:`make_injection_affine`), each bit whose emission is not the
    lowest readout wavelength is stored as ``stored(p) = true(A·p)``, an
    order-1 :func:`warp_affine` on ``device``, then clipped and truncated
    to uint16; the decode applies ``inv(chromatic)``, so the calibration
    that undoes the injection is ``A`` itself. The store keeps ``A``."""
    with profiling.span("datastore.convert"):
        with profiling.span("datastore.clip"):
            if inject_chromatic_aberration:
                corrected = raw.bits.copy()
            else:
                corrected = raw.bits.view()
                corrected.flags.writeable = False
                profiling.count("datastore.clip.passthrough", raw.bits.shape[0] * raw.bits.shape[1])
        if inject_chromatic_aberration:
            if injection_affine is None:
                injection_affine = make_injection_affine()
            with profiling.span("datastore.inject"):
                _inject(raw, corrected, injection_affine, device)
        wavelengths = [raw.fiducial_wavelengths_um[1]] + sorted(
            {float(w[1]) for w in raw.bit_wavelengths_um}
        )
        with profiling.span("datastore.psf"):
            psfs = make_channel_psfs(
                wavelengths, na=raw.na, ri=raw.ri, voxel_size_zyx_um=raw.voxel_size_zyx_um,
                shape_zyx=(15, 15, 15),
            )
        store = ArrayStore.from_arrays(
            gene_ids=raw.gene_ids,
            codebook_matrix=raw.codebook,
            voxel_size_zyx_um=raw.voxel_size_zyx_um,
            round_of_bit=raw.round_of_bit,
            bit_wavelengths_um=raw.bit_wavelengths_um,
            stage_positions_zyx_um=raw.stage_positions_zyx_um,
            corrected=corrected,
            fiducial_corrected=raw.fiducial,
            channel_psfs=psfs,
            na=raw.na,
            ri=raw.ri,
        )
        profiling.set_run(store.run_id)
    if inject_chromatic_aberration:
        store.injected_chromatic_affine = np.asarray(injection_affine, np.float64)
    return store


def _inject(raw: RawExperiment, corrected: np.ndarray, injection_affine, device) -> None:
    """Warp, in place in ``corrected``, every bit whose emission is not the
    lowest readout wavelength by ``injection_affine`` on ``device``."""
    reference_wl = sorted({float(w[1]) for w in raw.bit_wavelengths_um})[0]
    for b, wl in enumerate(raw.bit_wavelengths_um):
        if np.isclose(wl[1], reference_wl):
            continue
        for t in range(raw.bits.shape[0]):
            img = profiling.to_device(raw.bits[t, b], device).to(torch.float32)
            warped = warp_affine(img, transform_zyx_um=injection_affine,
                                 spacing_zyx_um=raw.voxel_size_zyx_um, reference_shape=img.shape)
            corrected[t, b] = profiling.to_host(warped.clamp(0, 65535).to(torch.int32)).astype(np.uint16)
