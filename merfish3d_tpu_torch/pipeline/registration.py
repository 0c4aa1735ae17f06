"""Fiducial round registration, deformable flow, RLGC deconvolution and
readout-bit preprocessing (counterpart of ``DataRegistration`` in
``merfish3d_tpu/pipeline/registration.py`` without multi-tile stitching).

Per tile: round 0's fiducial image, deconvolved with the fiducial PSF
when ``decon_fiducial`` (seed ``42 + tile``), is the reference (identity
transform). The moving rounds, in batches of ``round_batch_size`` (capped
by :func:`..ops.rlgc.max_vmap_batch`), are uploaded as u16, cast and
deconvolved on the device — one :func:`..ops.rlgc.rlgc_batch` when a
batch holds more than one round and y ≤ ``crop_yx_decon or 1024`` (seed
``42 + tile + 1000 + start``), else one :func:`..ops.rlgc.chunked_rlgc`
a round (seed ``42 + tile + 1000·round``) — and registered against the
reference by staged phase correlation
(:func:`..ops.registration.register_rounds_to_fixed`); the measured
translations become the store's round transforms, and the fiducials
resampled into the reference frame are stored as u16. With
``deformable_registration``, each resampled u16 round, still on the
device, and the reference volume give the round's residual flow field
(:func:`..ops.flow.estimate_sofima_flow_field_xyz_px` with
``sofima_config``), stored with its attributes.

Then the readout bits, grouped by PSF (excitation < 600 nm: PSF 1, else
2) and chunked by ``min(bit_batch_size, max_vmap_batch)``, are
deconvolved when ``decon_readout`` (seed ``7 + 100·tile + first bit``,
with the same batch-or-single choice), the spot predictor gives the
probability on the device — the U-FISH CNN resolved from ``ufish_model``
/ ``ufish_checkpoint`` as the reference resolves it (``"dog"`` asks for
the DoG predictor; a CNN alias with no local checkpoint falls back to it
with a warning), or an injected ``predictor`` — and both are stored in
the persisted forms (u16, u8 k/255); deconvolved volumes stay on the
device until then. The decoder resamples
each bit by its round's transform. The single tile's global transform is
the identity at its stage position.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..models.ufish import DEFAULT_UFISH_MODEL, get_predictor
from ..ops.flow import SofimaRegistrationConfig, estimate_sofima_flow_field_xyz_px
from ..ops.registration import register_rounds_to_fixed
from ..ops.rlgc import chunked_rlgc, max_vmap_batch, rlgc_batch
from ..utils import profiling
from ..utils.profiling import to_device, to_host
from .handoff import to_cache_forms


class DataRegistration:
    def __init__(
        self,
        store: ArrayStore,
        *,
        device="cuda",
        predictor: Optional[torch.nn.Module] = None,
        ufish_model: str = DEFAULT_UFISH_MODEL,
        ufish_checkpoint=None,
        bit_batch_size: int = 8,
        round_batch_size: int = 4,
        decon_fiducial: bool = True,
        decon_readout: bool = True,
        decon_max_iters: int = 40,
        crop_yx_decon: Optional[int] = None,
        deformable_registration: bool = False,
        sofima_config: SofimaRegistrationConfig = SofimaRegistrationConfig(),
    ):
        if (decon_fiducial or decon_readout) and not store.channel_psfs:
            raise ValueError(
                "deconvolution (decon_fiducial / decon_readout) needs the store's channel_psfs"
            )
        self._store = store
        self._device = torch.device(device)
        self._predictor = (
            predictor if predictor is not None
            else get_predictor(ufish_model, ufish_checkpoint, device=self._device)
        )
        self._bit_batch_size = max(1, int(bit_batch_size))
        self._round_batch_size = max(1, int(round_batch_size))
        self._decon_fiducial = bool(decon_fiducial)
        self._decon_readout = bool(decon_readout)
        self._decon_max_iters = int(decon_max_iters)
        self._crop_yx_decon = crop_yx_decon
        self._deformable = bool(deformable_registration)
        self._sofima_config = sofima_config

    def register_all_tiles(self) -> None:
        store = self._store
        if store.num_tiles != 1:
            raise NotImplementedError(
                "multi-tile global registration is not ported; one tile only"
            )
        for tile in range(store.num_tiles):
            with profiling.span("registration.tile", run=store.run_id):
                with profiling.span("registration.fiducial"):
                    self._generate_registrations(tile)
                with profiling.span("registration.bits"):
                    self._apply_registration_to_bits(tile)
            store.global_xforms[tile] = (
                np.eye(4),
                np.asarray(store.stage_positions_zyx_um[tile], np.float64),
                np.asarray(store.voxel_size_zyx_um, np.float64),
            )

    # ------------------------------------------------------------- decon
    def _psf_for_channel(self, psf_idx: int) -> np.ndarray:
        psfs = self._store.channel_psfs
        return psfs[min(psf_idx, len(psfs) - 1)]

    def _psf_idx_for_bit(self, bit: int) -> int:
        """Excitation below 600 nm → PSF 1, else 2."""
        return 1 if self._store.bit_wavelengths_um[bit][0] < 0.600 else 2

    def _deconvolve(self, image: torch.Tensor, psf: np.ndarray, seed: int) -> torch.Tensor:
        return chunked_rlgc(
            image, psf, crop_yx=self._crop_yx_decon, seed=seed,
            max_iters=self._decon_max_iters, out="device",
        )

    def _decon_stack(self, raws: np.ndarray, psf: Optional[np.ndarray], seed: int, single_seeds):
        """A stack of u16 volumes, uploaded as u16, cast on the device and
        deconvolved: one batch solve when it holds more than one volume
        and y ≤ ``crop_yx_decon or 1024``, else one tiled solve each."""
        stack = to_device(raws, self._device).to(torch.float32)
        if psf is None:
            return stack
        if len(raws) > 1 and raws.shape[-2] <= (self._crop_yx_decon or 1024):
            return rlgc_batch(stack, psf, seed=seed, max_iters=self._decon_max_iters, out="device")
        return torch.stack([self._deconvolve(v, psf, s) for v, s in zip(stack, single_seeds)])

    # ----------------------------------------------------- fiducial rounds
    @torch.no_grad()
    def _generate_registrations(self, tile: int) -> None:
        store = self._store
        fid_psf = self._psf_for_channel(0) if self._decon_fiducial else None
        reference_dev = self._decon_stack(
            store.fiducial_corrected[(tile, 0)][None], fid_psf, 42 + tile, [42 + tile]
        )[0]
        store.round_transforms[(tile, 0)] = np.eye(4)
        store.fiducial_registered[(tile, 0)] = (
            to_host(reference_dev.clamp(0, 65535).to(torch.int32)).astype(np.uint16)
        )
        moving = list(range(1, store.num_rounds))
        batch = self._round_batch_size
        if fid_psf is not None:
            batch = min(batch, max_vmap_batch(reference_dev.shape, fid_psf.shape))
        for start in range(0, len(moving), batch):
            rounds = moving[start : start + batch]
            raws = np.stack([store.fiducial_corrected[(tile, r)] for r in rounds])
            movings = self._decon_stack(
                raws, fid_psf, 42 + tile + 1000 + start, [42 + tile + r * 1000 for r in rounds]
            )
            with profiling.span("registration.phase_corr"):
                transforms, warped = register_rounds_to_fixed(
                    reference_dev, movings, spacing_zyx_um=store.voxel_size_zyx_um,
                    return_warped=True, device=self._device,
                )
            warped_host = to_host(warped)
            for i, r in enumerate(rounds):
                store.round_transforms[(tile, r)] = transforms[i].astype(np.float64)
                store.fiducial_registered[(tile, r)] = warped_host[i]
                if self._deformable:
                    flow, meta = estimate_sofima_flow_field_xyz_px(reference_dev, warped[i], self._sofima_config)
                    store.save_local_sofima_flow_field(flow, tile=tile, round=r, **meta)

    # ------------------------------------------------------- readout bits
    @torch.no_grad()
    def _apply_registration_to_bits(self, tile: int) -> None:
        store = self._store
        groups: dict[int, list[int]] = {}
        for b in range(store.num_bits):
            groups.setdefault(self._psf_idx_for_bit(b) if self._decon_readout else -1, []).append(b)
        for psf_idx, members in groups.items():
            psf = self._psf_for_channel(psf_idx) if psf_idx >= 0 else None
            batch = self._bit_batch_size
            if psf is not None:
                batch = min(batch, max_vmap_batch(store.corrected[(tile, members[0])].shape, psf.shape))
            for start in range(0, len(members), batch):
                chunk = members[start : start + batch]
                raws = np.stack([store.corrected[(tile, b)] for b in chunk])
                decons = self._decon_stack(
                    raws, psf, 7 + tile * 100 + chunk[0], [7 + tile * 100 + b for b in chunk]
                )
                with profiling.span("registration.predict"):
                    probs = self._predictor(decons)
                with profiling.span("registration.download"):
                    du, pu = to_cache_forms(decons, probs)
                    del probs
                    du, pu = to_host(du), to_host(pu)
                for i, b in enumerate(chunk):
                    store.registered[(tile, b)] = du[i]
                    store.feature_predictor[(tile, b)] = pu[i]
