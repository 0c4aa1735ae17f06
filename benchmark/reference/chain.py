"""The reference chain on one tile: convert, register (and deconvolve),
decode. Entry points mirror the program's: :func:`convert_data`,
:class:`.registration.DataRegistration`, :func:`decode_pixels`."""

from __future__ import annotations

import numpy as np

from .chromatic import estimate_chromatic_affines_from_barcodes, save_identity_chromatic_affines
from .decoder import PixelDecoder
from .filtering import filter_blank_fraction, is_blank, table_len
from .psf import make_channel_psfs
from .registration import DataRegistration
from .store import ArrayStore


def convert_data(tile) -> ArrayStore:
    """A rendered tile (the benchmark generator's :class:`Tile`) → store:
    readout bits clipped to u16 as corrected images, fiducial rounds as
    they are, and the channel PSFs (Gaussian, (15, 15, 15), fiducial
    emission first, then each readout emission wavelength in order)."""
    corrected = np.clip(tile.bits.astype(np.float32), 0, 65535).astype(np.uint16)
    wavelengths = [tile.fiducial_wavelengths_um[1]] + sorted({float(w[1]) for w in tile.bit_wavelengths_um})
    psfs = make_channel_psfs(wavelengths, na=tile.na, ri=tile.ri, voxel_size_zyx_um=tile.voxel_size_zyx_um,
                             shape_zyx=(15, 15, 15))
    return ArrayStore.from_arrays(
        gene_ids=tile.gene_ids, codebook_matrix=tile.codebook, voxel_size_zyx_um=tile.voxel_size_zyx_um,
        round_of_bit=tile.round_of_bit, bit_wavelengths_um=tile.bit_wavelengths_um,
        stage_positions_zyx_um=tile.stage_positions_zyx_um, corrected=corrected,
        fiducial_corrected=tile.fiducial, channel_psfs=psfs, na=tile.na, ri=tile.ri,
    )


def decode_pixels(store: ArrayStore, *, device, minimum_pixels: int, magnitude_threshold,
                  num_iterations: int, target_misid_rate: float, estimate_chromatic_affines: bool,
                  lowpass_sigma=(3.0, 1.0, 1.0)) -> dict:
    """Normalization optimization (with the chromatic estimate after each
    pass when asked), the final decode and the blank-fraction filter."""
    decoder = PixelDecoder(store, device=device, magnitude_threshold=tuple(magnitude_threshold),
                           minimum_pixels=minimum_pixels, estimate_chromatic_affines=estimate_chromatic_affines)
    decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=num_iterations,
                                               lowpass_sigma=tuple(lowpass_sigma))
    return decoder.decode_all_tiles(lowpass_sigma=tuple(lowpass_sigma), filter_method="blank_fraction",
                                    target_misid_rate=target_misid_rate)


def handoff_store(tile, handoff) -> ArrayStore:
    """A store holding another run's handoff to the decode (its stored
    deconvolved stack and spot probabilities, round transforms and flow
    fields) with the tile's own metadata, for :func:`decode_pixels`."""
    rounds = int(np.max(tile.round_of_bit)) + 1
    return ArrayStore.from_arrays(
        gene_ids=tile.gene_ids, codebook_matrix=tile.codebook, voxel_size_zyx_um=tile.voxel_size_zyx_um,
        round_of_bit=tile.round_of_bit, bit_wavelengths_um=tile.bit_wavelengths_um,
        stage_positions_zyx_um=tile.stage_positions_zyx_um,
        registered=[handoff.registered], feature_predictor=[handoff.predictor],
        round_transforms=[[handoff.transforms[r] for r in range(rounds)]],
        global_xforms=[(np.eye(4), np.asarray(tile.stage_positions_zyx_um[0], np.float64),
                        np.asarray(tile.voxel_size_zyx_um, np.float64))],
        flow_fields={(0, r): flow for r, flow in handoff.flows.items()}, na=tile.na, ri=tile.ri,
    )


def replay_decode(store: ArrayStore, passes: list, *, device, minimum_pixels: int, magnitude_threshold,
                  num_iterations: int, target_misid_rate: float, estimate_chromatic_affines: bool,
                  lowpass_sigma=(3.0, 1.0, 1.0)) -> tuple[list, dict]:
    """The decode of another run, followed from that run's own state: the
    seeding from ``store``'s handoff, then each optimization pass decoded
    here while the normalization vectors and the chromatic affines that
    the next pass uses are worked out from that run's table of the pass
    (``passes``). Returns (this decode's pass tables, its final table
    before the filter); ``store`` ends with the affines worked out from
    ``passes``."""
    decoder = PixelDecoder(store, device=device, magnitude_threshold=tuple(magnitude_threshold),
                           minimum_pixels=minimum_pixels, estimate_chromatic_affines=estimate_chromatic_affines)
    sigma = tuple(lowpass_sigma)
    nb = store.num_bits
    if estimate_chromatic_affines:
        save_identity_chromatic_affines(store, nb)
        decoder._collect_chromatic_centroids = True
    decoder._global_normalization_vectors(tile_indices=[0], lowpass_sigma=sigma)
    tables = []
    for it in range(num_iterations):
        tables.append(decoder.decode_one_tile(0, lowpass_sigma=sigma, optimize_normalization_weights=True))
        decoder._barcodes_loaded = passes[it]
        if estimate_chromatic_affines and table_len(passes[it]):
            estimate_chromatic_affines_from_barcodes(store, passes[it], n_merfish_bits=nb,
                                                     config=decoder._chromatic_affine_config)
        decoder._iterative_normalization_vectors()
    decoder._collect_chromatic_centroids = False
    final = decoder.decode_all_tiles(lowpass_sigma=sigma, filter_method="none")
    return tables, final


def blank_fraction_filter(store: ArrayStore, table: dict, target_misid_rate: float) -> dict:
    """The decode's last step on a final table: the blank-fraction filter
    over the store's codebook."""
    if not table_len(table):
        return table
    genes = np.asarray(store.gene_ids, dtype=object)[store.codebook_matrix.sum(axis=1) > 1]
    return filter_blank_fraction(table, n_blank_codewords=int(is_blank(genes).sum()),
                                 n_total_codewords=len(genes), target_misid_rate=target_misid_rate)
