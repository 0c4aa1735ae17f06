"""Raw acquisition → datastore (counterpart of ``convert_data`` in
``merfish3d_tpu/cli/simulation/convert_to_datastore.py``), into an
in-memory :class:`ArrayStore`. Chromatic-aberration injection is not
ported."""

from __future__ import annotations

import numpy as np

from ...datastore.array_store import ArrayStore
from .convert_simulation_to_experiment import RawExperiment


def convert_data(raw: RawExperiment) -> ArrayStore:
    """Readout bits become the store's corrected images (clipped to the
    uint16 range, as the reference stores them); fiducial rounds become
    its corrected fiducial images."""
    corrected = np.clip(raw.bits.astype(np.float32), 0, 65535).astype(np.uint16)
    return ArrayStore.from_arrays(
        gene_ids=raw.gene_ids,
        codebook_matrix=raw.codebook,
        voxel_size_zyx_um=raw.voxel_size_zyx_um,
        round_of_bit=raw.round_of_bit,
        bit_wavelengths_um=raw.bit_wavelengths_um,
        stage_positions_zyx_um=raw.stage_positions_zyx_um,
        corrected=corrected,
        fiducial_corrected=raw.fiducial,
    )
