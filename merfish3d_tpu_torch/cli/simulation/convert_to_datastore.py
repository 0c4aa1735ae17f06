"""Raw acquisition → datastore (counterpart of ``convert_data`` in
``merfish3d_tpu/cli/simulation/convert_to_datastore.py``), into an
in-memory :class:`ArrayStore`, with the reference's channel PSFs.
Chromatic-aberration injection is not ported."""

from __future__ import annotations

import numpy as np

from ...datastore.array_store import ArrayStore
from ...models.psf import make_channel_psfs
from .convert_simulation_to_experiment import RawExperiment


def convert_data(raw: RawExperiment) -> ArrayStore:
    """Readout bits become the store's corrected images (clipped to the
    uint16 range, as the reference stores them); fiducial rounds become
    its corrected fiducial images. The channel PSFs are the reference's:
    Gaussian, (15, 15, 15), at the fiducial emission wavelength and then
    at each readout emission wavelength in order."""
    corrected = np.clip(raw.bits.astype(np.float32), 0, 65535).astype(np.uint16)
    wavelengths = [raw.fiducial_wavelengths_um[1]] + sorted(
        {float(w[1]) for w in raw.bit_wavelengths_um}
    )
    psfs = make_channel_psfs(
        wavelengths, na=raw.na, ri=raw.ri, voxel_size_zyx_um=raw.voxel_size_zyx_um,
        shape_zyx=(15, 15, 15),
    )
    return ArrayStore.from_arrays(
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
