"""Fiducial round registration and readout-bit preprocessing (counterpart
of ``DataRegistration`` in ``merfish3d_tpu/pipeline/registration.py``
without deconvolution, deformable flow or multi-tile stitching).

Per tile: round 0's fiducial image is the reference (identity transform);
the moving rounds, in batches of ``round_batch_size``, are uploaded as
u16, cast on the device and registered against it by staged phase
correlation (:func:`..ops.registration.register_rounds_to_fixed`); the
measured translations become the store's round transforms, and the
fiducials resampled into the reference frame are stored as u16. Then per
readout bit: the corrected image is the registered image (no
deconvolution), the DoG predictor gives the spot probability, and both
are stored in the persisted forms (u16, u8 k/255); the decoder resamples
each bit by its round's transform. The single tile's global transform is
the identity at its stage position.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..models.ufish import DoGSpotPredictor
from ..ops.registration import register_rounds_to_fixed
from .handoff import to_cache_forms


class DataRegistration:
    def __init__(
        self,
        store: ArrayStore,
        *,
        device="cuda",
        predictor: DoGSpotPredictor | None = None,
        bit_batch_size: int = 8,
        round_batch_size: int = 4,
        decon_fiducial: bool = False,
        decon_readout: bool = False,
    ):
        if decon_fiducial or decon_readout:
            raise NotImplementedError(
                "RLGC deconvolution (decon_fiducial / decon_readout) is not ported yet: "
                "it comes with the RLGC slice (ops/rlgc.py)"
            )
        self._store = store
        self._device = torch.device(device)
        self._predictor = predictor if predictor is not None else DoGSpotPredictor()
        self._bit_batch_size = max(1, int(bit_batch_size))
        self._round_batch_size = max(1, int(round_batch_size))

    def register_all_tiles(self) -> None:
        store = self._store
        if store.num_tiles != 1:
            raise NotImplementedError(
                "multi-tile global registration is not ported; one tile only"
            )
        for tile in range(store.num_tiles):
            self._generate_registrations(tile)
            self._apply_registration_to_bits(tile)
            store.global_xforms[tile] = (
                np.eye(4),
                np.asarray(store.stage_positions_zyx_um[tile], np.float64),
                np.asarray(store.voxel_size_zyx_um, np.float64),
            )

    @torch.no_grad()
    def _generate_registrations(self, tile: int) -> None:
        store = self._store
        reference = store.fiducial_corrected[(tile, 0)]
        reference_dev = torch.as_tensor(reference, device=self._device).to(torch.float32)
        store.round_transforms[(tile, 0)] = np.eye(4)
        store.fiducial_registered[(tile, 0)] = reference.copy()
        moving = list(range(1, store.num_rounds))
        for start in range(0, len(moving), self._round_batch_size):
            rounds = moving[start : start + self._round_batch_size]
            raws = np.stack([store.fiducial_corrected[(tile, r)] for r in rounds])
            # upload u16, cast on the device
            movings = torch.as_tensor(raws, device=self._device).to(torch.float32)
            transforms, warped = register_rounds_to_fixed(
                reference_dev, movings, spacing_zyx_um=store.voxel_size_zyx_um,
                return_warped=True, device=self._device,
            )
            for i, r in enumerate(rounds):
                store.round_transforms[(tile, r)] = transforms[i].astype(np.float64)
                store.fiducial_registered[(tile, r)] = warped[i]

    @torch.no_grad()
    def _apply_registration_to_bits(self, tile: int) -> None:
        store = self._store
        bits = list(range(store.num_bits))
        for start in range(0, len(bits), self._bit_batch_size):
            chunk = bits[start : start + self._bit_batch_size]
            raws = np.stack([store.corrected[(tile, b)] for b in chunk])
            # upload u16, cast on the device
            decons = torch.as_tensor(raws, device=self._device).to(torch.float32)
            du, pu = to_cache_forms(decons, self._predictor(decons))
            du, pu = du.cpu().numpy(), pu.cpu().numpy()
            for i, b in enumerate(chunk):
                store.registered[(tile, b)] = du[i]
                store.feature_predictor[(tile, b)] = pu[i]
