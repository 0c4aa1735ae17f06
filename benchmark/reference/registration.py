"""Fiducial round registration, deformable flow, RLGC and the spot
probability of one tile (frozen copy of the program's
``DataRegistration`` at one tile; every solve is :func:`.rlgc.rlgc_batch`
on one volume). It takes the program's options by the same names and
defaults; the U-FISH network's variables come as the dict itself
(``ufish_variables``) where the program reads the file they were written
to. It refuses with ``NotImplementedError`` what it has no plain version
of: a U-FISH predictor without variables, and a lateral-tiled solve (y or
x above the program's crop for a single-volume solve).

The solves and their seeds are the program's. A stack of volumes sharing
a PSF is one batch solve where it holds more than one volume and y ≤
``crop_yx_decon or 1024`` (volume ``i`` seeded ``batch seed + i``), else
one solve a volume with the volume's own seed.

With ``decon_fiducial``, round 0's fiducial image is deconvolved with the
fiducial PSF (one solve, seed ``42 + tile``) and the moving rounds, in
batches of ``min(4, max batch)``, are deconvolved (batch
seed ``42 + tile + 1000 + first index``, single seed ``42 + tile +
1000·round``) before registration. Round 0's image, stored as u16, is the
reference; the moving rounds are registered by staged phase correlation
and stored warped, and, with ``deformable_registration``, each warped
round and the reference give the round's flow field. The readout bits,
grouped by PSF (excitation below 600 nm: PSF 1, else 2) in chunks of
``min(8, max batch)``, are deconvolved when
``decon_readout`` (batch seed ``7 + 100·tile + first bit``, single seed
``7 + 100·tile + bit``), scored by the DoG predictor or the U-FISH
network and stored as u16 and u8 k/255.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .dog import dog_probability
from .flow import SofimaRegistrationConfig, estimate_sofima_flow_field_xyz_px
from .handoff import to_cache_forms
from .registration_ops import register_rounds_to_fixed
from .rlgc import auto_crop_yx, max_batch, rlgc_batch
from .store import ArrayStore
from .ufish import UFish, ufish_probability

BIT_BATCH, ROUND_BATCH = 8, 4  # the program's default batch sizes, before its memory cap


class DataRegistration:
    def __init__(self, store: ArrayStore, *, device="cuda", ufish_model: str = "simfish",
                 ufish_variables: Optional[dict] = None, decon_fiducial: bool = True, decon_readout: bool = True, decon_max_iters: int = 40,
                 crop_yx_decon: Optional[int] = None, deformable_registration: bool = False,
                 sofima_config: SofimaRegistrationConfig = SofimaRegistrationConfig()):
        if ufish_variables is None and ufish_model.lower() not in ("dog", "none"):
            raise NotImplementedError(f"the reference has no weights for the U-FISH model {ufish_model!r}")
        self._store = store
        self._device = torch.device(device)
        self._net = None if ufish_variables is None else UFish(ufish_variables, self._device)
        self._decon_fiducial = bool(decon_fiducial)
        self._decon_readout = bool(decon_readout)
        self._decon_max_iters = int(decon_max_iters)
        self._crop_yx_decon = crop_yx_decon
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

    def _decon_stack(self, raws: np.ndarray, psf, seed: int, single_seeds) -> torch.Tensor:
        """A (B, Z, Y, X) stack as float32 on the device, deconvolved when
        ``psf`` is given, with the program's seeds: ``seed + i`` for volume
        ``i`` of a batch solve, else each volume's own."""
        stack = torch.as_tensor(raws, device=self._device).to(torch.float32)
        if psf is None:
            return stack
        batch = len(raws) > 1 and raws.shape[-2] <= (self._crop_yx_decon or 1024)
        crop = self._crop_yx_decon or auto_crop_yx(raws.shape[1:], psf.shape)
        if not batch and max(raws.shape[-2:]) > crop:
            raise NotImplementedError(f"the reference has no lateral-tiled solve: {raws.shape[1:]} above crop {crop}")
        out = torch.empty_like(stack)
        for i in range(len(raws)):
            out[i:i + 1], iters = rlgc_batch(stack[i:i + 1], psf, seed=seed + i if batch else single_seeds[i],
                                             max_iters=self._decon_max_iters)
            self.iterations += iters
        return out

    def _predict(self, stack: torch.Tensor) -> torch.Tensor:
        return dog_probability(stack) if self._net is None else ufish_probability(stack, self._net)

    @torch.no_grad()
    def _generate_registrations(self, tile: int) -> None:
        store = self._store
        fid_psf = self._psf_for_channel(0) if self._decon_fiducial else None
        reference_dev = self._decon_stack(store.fiducial_corrected[(tile, 0)][None], fid_psf,
                                          42 + tile, [42 + tile])[0]
        store.round_transforms[(tile, 0)] = np.eye(4)
        store.fiducial_registered[(tile, 0)] = (
            reference_dev.clamp(0, 65535).to(torch.int32).to(torch.uint16).cpu().numpy()
        )
        moving = list(range(1, store.num_rounds))
        batch = ROUND_BATCH
        if fid_psf is not None:
            batch = min(batch, max_batch(reference_dev.shape, fid_psf.shape))
        for start in range(0, len(moving), batch):
            rounds = moving[start : start + batch]
            raws = np.stack([store.fiducial_corrected[(tile, r)] for r in rounds])
            movings = self._decon_stack(raws, fid_psf, 42 + tile + 1000 + start,
                                        [42 + tile + r * 1000 for r in rounds])
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
            psf = self._psf_for_channel(psf_idx) if psf_idx >= 0 else None
            batch = BIT_BATCH
            if psf is not None:
                batch = min(batch, max_batch(store.corrected[(tile, members[0])].shape, psf.shape))
            for start in range(0, len(members), batch):
                chunk = members[start : start + batch]
                raws = np.stack([store.corrected[(tile, b)] for b in chunk])
                decons = self._decon_stack(raws, psf, 7 + tile * 100 + chunk[0], [7 + tile * 100 + b for b in chunk])
                for i, b in enumerate(chunk):
                    du, pu = to_cache_forms(decons[i:i + 1], self._predict(decons[i:i + 1]))
                    store.registered[(tile, b)] = du[0].cpu().numpy()
                    store.feature_predictor[(tile, b)] = pu[0].cpu().numpy()
