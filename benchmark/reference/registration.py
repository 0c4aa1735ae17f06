"""Fiducial round registration, deformable flow, RLGC on the readout bits
and the DoG spot probability of one tile (frozen copy of the program's
``DataRegistration`` at one tile; the readout solve is
:func:`.rlgc.rlgc_batch`). It takes the program's options by the same
names and defaults, and refuses with ``NotImplementedError`` those it has
no plain version of: fiducial deconvolution and any predictor but DoG.

Round 0's fiducial image is the reference; the moving rounds, four at a
time, are registered by staged phase correlation and, with
``deformable_registration``, each resampled round and the reference give
the round's flow field. The readout bits, grouped by PSF (excitation
below 600 nm: PSF 1, else 2) in chunks of 8, are deconvolved one by one
when ``decon_readout`` (volume ``i`` of a chunk seeded ``7 + 100·tile +
first bit + i``, as a batch solve seeds it), scored by the DoG predictor
and stored as u16 and u8 k/255.
"""

from __future__ import annotations

import numpy as np
import torch

from .dog import dog_probability
from .flow import SofimaRegistrationConfig, estimate_sofima_flow_field_xyz_px
from .handoff import to_cache_forms
from .registration_ops import register_rounds_to_fixed
from .rlgc import rlgc_batch
from .store import ArrayStore


class DataRegistration:
    def __init__(self, store: ArrayStore, *, device="cuda", ufish_model: str = "simfish",
                 decon_fiducial: bool = True, decon_readout: bool = True, decon_max_iters: int = 40,
                 deformable_registration: bool = False,
                 sofima_config: SofimaRegistrationConfig = SofimaRegistrationConfig()):
        if ufish_model != "dog":
            raise NotImplementedError(f"the reference scores spots with DoG only, not {ufish_model!r}")
        if decon_fiducial:
            raise NotImplementedError("the reference has no fiducial deconvolution")
        self._store = store
        self._device = torch.device(device)
        self._decon_readout = bool(decon_readout)
        self._decon_max_iters = int(decon_max_iters)
        self._deformable = bool(deformable_registration)
        self._sofima_config = sofima_config
        self.iterations: list[int] = []

    def register_all_tiles(self) -> None:
        store = self._store
        for tile in range(store.num_tiles):
            self._generate_registrations(tile)
            self._apply_registration_to_bits(tile)
            store.global_xforms[tile] = (
                np.eye(4),
                np.asarray(store.stage_positions_zyx_um[tile], np.float64),
                np.asarray(store.voxel_size_zyx_um, np.float64),
            )

    def _psf_for_channel(self, psf_idx: int) -> np.ndarray:
        psfs = self._store.channel_psfs
        return psfs[min(psf_idx, len(psfs) - 1)]

    def _psf_idx_for_bit(self, bit: int) -> int:
        """Excitation below 600 nm → PSF 1, else 2."""
        return 1 if self._store.bit_wavelengths_um[bit][0] < 0.600 else 2

    @torch.no_grad()
    def _generate_registrations(self, tile: int) -> None:
        store = self._store
        reference_dev = torch.as_tensor(store.fiducial_corrected[(tile, 0)], device=self._device).to(torch.float32)
        store.round_transforms[(tile, 0)] = np.eye(4)
        store.fiducial_registered[(tile, 0)] = store.fiducial_corrected[(tile, 0)]
        moving = list(range(1, store.num_rounds))
        for start in range(0, len(moving), 4):
            rounds = moving[start : start + 4]
            raws = np.stack([store.fiducial_corrected[(tile, r)] for r in rounds])
            movings = torch.as_tensor(raws, device=self._device).to(torch.float32)
            transforms, warped = register_rounds_to_fixed(
                reference_dev, movings, spacing_zyx_um=store.voxel_size_zyx_um,
                return_warped=True, device=self._device,
            )
            warped_host = warped.cpu().numpy()
            for i, r in enumerate(rounds):
                store.round_transforms[(tile, r)] = transforms[i].astype(np.float64)
                store.fiducial_registered[(tile, r)] = warped_host[i]
                if self._deformable:
                    flow, meta = estimate_sofima_flow_field_xyz_px(reference_dev, warped[i], self._sofima_config)
                    store.save_local_sofima_flow_field(flow, tile=tile, round=r, **meta)

    @torch.no_grad()
    def _apply_registration_to_bits(self, tile: int) -> None:
        store = self._store
        groups: dict[int, list[int]] = {}
        for b in range(store.num_bits):
            groups.setdefault(self._psf_idx_for_bit(b) if self._decon_readout else -1, []).append(b)
        for psf_idx, members in groups.items():
            for start in range(0, len(members), 8):
                chunk = members[start : start + 8]
                for i, b in enumerate(chunk):
                    # volume i of a chunk solved in one batch is seeded chunk seed + i
                    stack = torch.as_tensor(store.corrected[(tile, b)][None], device=self._device).to(torch.float32)
                    if psf_idx >= 0:
                        stack, iters = rlgc_batch(stack, self._psf_for_channel(psf_idx),
                                                  seed=7 + tile * 100 + chunk[0] + i, max_iters=self._decon_max_iters)
                        self.iterations += iters
                    du, pu = to_cache_forms(stack, dog_probability(stack))
                    store.registered[(tile, b)] = du[0].cpu().numpy()
                    store.feature_predictor[(tile, b)] = pu[0].cpu().numpy()
