"""PixelDecoder (counterpart of the single-tile subset of
``merfish3d_tpu/pipeline/decoder.py``): codebook and caller thresholds,
normalization seeding, the normalization-by-decoding loop, the final
lowpass + decode, component extraction and the blank-fraction filter,
over an :class:`ArrayStore`; with ``estimate_chromatic_affines`` the
normalization loop also estimates the chromatic affines from the decoded
transcripts after each pass (:mod:`.chromatic`), and the next pass
decodes a stack warped with them.

Device work runs on the decoder's ``device``. The optimization passes
decode through kernel K3 (after the plain lowpass) and the final decode
through the fused kernels K1+K2 — the split the reference makes on TPU —
and the decode's outputs stay on the device, where the components are
labelled and summed (``csrc/components.cu``); only the rows of the
components within the size window come down. On a CPU device every
kernel runs as its plain torch version, on the same route.

Not ported: the mesh fan-out, multi-tile duplicate removal, the
LR filter, 2D mode, masks, z ranges and on-disk resume of the
optimization loop.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch

from ..datastore.array_store import ArrayStore
from ..models.ufish import median_last
from ..ops.cc import component_stats_host, inertia_tensor_eigvals
from ..ops.components import label_components
from ..ops.decode import caller_thresholds, decode_volume
from ..ops.filters import gaussian_lowpass
from ..ops.fused_decode import fused_decode_volume
from ..utils import profiling
from ..utils.profiling import read_scalar, to_device, to_host
from . import decode_warping
from .chromatic import (
    ChromaticAffineEstimationConfig,
    estimate_chromatic_affines_from_barcodes,
    save_identity_chromatic_affines,
)
from .filtering import concat_tables, filter_blank_fraction, is_blank, select_rows, table_len
from .handoff import product_f32

DEFAULT_DECODE_LOWPASS_SIGMA = (3.0, 1.0, 1.0)


def percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row ``q``-th percentile of a (rows, n) tensor with linear
    interpolation (numpy's and jnp's default). Sort-based: torch.quantile
    refuses inputs above 2**24 elements, one production tile-bit's size."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    pos = q / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    w = pos - lo
    return s[..., lo] * (1.0 - w) + s[..., hi] * w


def _sparse_support_bit(support_count: int, total_voxels: int, high_cut: float) -> bool:
    """Whether a bit is too spot-sparse for the percentile seed recipe:
    pre-lowpass support under half the percentile tail (f32 compare, as
    the reference's device program does)."""
    return np.float32(support_count) < np.float32(0.5 * (1.0 - high_cut / 100.0) * total_voxels)


def seed_lowpass_program(stack: torch.Tensor, *, hot_threshold: float, sigma):
    """One tile's (bits, z, y, x) stack → hot pixels replaced by the bit's
    mid-plane median, then the Gaussian lowpass per bit. Also returns each
    bit's pre-lowpass positive-support count."""
    med = median_last(stack[:, stack.shape[1] // 2], dims=2)
    cleaned = torch.where(stack > hot_threshold, med[:, None, None, None], stack)
    support = (cleaned > 0.0).sum(dim=(1, 2, 3))
    lp = torch.stack([gaussian_lowpass(v, sigma=sigma) for v in cleaned])
    return lp, to_host(support).astype(np.int64)


def seed_stats_program(stacks, *, sigma, hot_threshold: float, low_cut: float, high_cut: float):
    """Global normalization seeding: per bit, the per-tile ``low_cut``
    percentile cuts and the median of the union of pixels below them
    (background), then the median of the union above the per-tile
    ``high_cut`` percentiles of the background-shifted pixels (norm) — or,
    for a spot-sparse bit, a quarter of the median of its support-count
    brightest voxels. Returns (norm, bg) float32 (bits,)."""
    seeded = [seed_lowpass_program(s, hot_threshold=hot_threshold, sigma=sigma) for s in stacks]
    n_bits = seeded[0][0].shape[0]
    norm = np.ones(n_bits, np.float32)
    bg = np.zeros(n_bits, np.float32)
    for b in range(n_bits):
        vbt = torch.stack([lp[b].reshape(-1) for lp, _ in seeded])  # (T, V)
        support_b = int(sum(sup[b] for _, sup in seeded))
        cuts = percentile_linear(vbt, low_cut)
        low = vbt[vbt < cuts[:, None]]
        profiling.count("copy.reads")  # a boolean index reads its selection's size back
        bg_b = median_last(low) if low.numel() else torch.zeros((), device=vbt.device)
        shifted = torch.clamp(vbt - bg_b, min=0.0)
        if _sparse_support_bit(support_b, vbt.numel(), high_cut):
            # median of the support-count brightest voxels (spot-core
            # scale), biased 4x down so the optimizer climbs to it
            asc = torch.sort(shifted.reshape(-1)).values
            n_tot = asc.numel()
            k_sup = min(max(support_b, 1), n_tot)
            start = n_tot - k_sup
            norm_b = 0.125 * (asc[start + max((k_sup - 1) // 2, 0)] + asc[start + k_sup // 2])
        else:
            hcuts = percentile_linear(shifted, high_cut)
            high = shifted[shifted > hcuts[:, None]]
            profiling.count("copy.reads")
            norm_b = median_last(high) if high.numel() else torch.ones((), device=vbt.device)
        norm[b] = read_scalar(norm_b)
        bg[b] = read_scalar(bg_b)
    return norm, bg


class PixelDecoder:
    """Per-pixel MERFISH decoder over an :class:`ArrayStore`."""

    def __init__(
        self,
        store: ArrayStore,
        *,
        device="cuda",
        merfish_bits: Optional[int] = None,
        magnitude_threshold: tuple[float, float] = (1.5, 10.0),
        minimum_pixels: int = 16,
        maximum_pixels: int = 500,
        estimate_chromatic_affines: bool = False,
        chromatic_affine_config: ChromaticAffineEstimationConfig = ChromaticAffineEstimationConfig(),
    ):
        self._store = store
        self._device = torch.device(device)
        self._magnitude_threshold = tuple(float(v) for v in magnitude_threshold)
        self._minimum_pixels = float(minimum_pixels)
        self._maximum_pixels = float(maximum_pixels)
        self._n_merfish_bits = int(merfish_bits or store.num_bits)
        self._estimate_chromatic = bool(estimate_chromatic_affines)
        self._chromatic_affine_config = chromatic_affine_config
        self._collect_chromatic_centroids = False
        self._load_codebook()
        self._global_normalization_vector: Optional[np.ndarray] = None
        self._global_background_vector: Optional[np.ndarray] = None
        self._iterative_normalization_vector: Optional[np.ndarray] = None
        self._iterative_background_vector: Optional[np.ndarray] = None
        self._barcodes_loaded: dict = {}
        # one-deep device memo: seeding, every optimization pass and the
        # final decode of a tile reuse one warped product stack, keyed by
        # (tile, the store's chromatic and flow versions): every calibration
        # save and every flow-field write makes the warped stack stale
        self._warped_memo: Optional[tuple[tuple[int, int, int], torch.Tensor]] = None

    # ------------------------------------------------------------- codebook
    def _load_codebook(self) -> None:
        """Drop 1-on-bit codewords; derive the caller thresholds from the
        median on-bit count B."""
        matrix = self._store.codebook_matrix[:, : self._n_merfish_bits].astype(np.float32)
        gene_ids = np.asarray(self._store.gene_ids, dtype=object)
        keep = matrix.sum(axis=1) > 1
        self._codebook_matrix = matrix[keep]
        self._gene_ids = gene_ids[keep]
        self._blank_mask = is_blank(self._gene_ids)
        b = int(np.median(self._codebook_matrix.sum(axis=1)))
        self._pixel_distance_threshold, self._transcript_distance_threshold = (
            caller_thresholds(b)
        )
        self._on_bits_1based = (
            np.argsort(~self._codebook_matrix.astype(bool), axis=1, kind="stable")[:, :b]
            .astype(np.int32)
            + 1
        )

    @property
    def gene_ids(self) -> list[str]:
        return [str(g) for g in self._gene_ids]

    # ------------------------------------------------------- bit data loads
    def _load_warped_bit_stack(self, tile_idx: int) -> torch.Tensor:
        """decon × probability of every bit, in the round-1 frame, as one
        (bits, z, y, x) float32 stack on the device (u16 and u8 upload)."""
        key = (tile_idx, self._store.chromatic_version, self._store.flow_version)
        if self._warped_memo is not None and self._warped_memo[0] == key:
            return self._warped_memo[1]
        self._warped_memo = None
        with profiling.span("decoder.load"):
            du, pu = self._store.registered_stack(tile_idx)
            nb = self._n_merfish_bits
            stack = product_f32(to_device(du[:nb], self._device), to_device(pu[:nb], self._device))
            with profiling.span("decoder.warp"):
                warped = decode_warping.warp_bit_images_to_reference(
                    stack, store=self._store, tile=tile_idx, bits=range(nb)
                )
        self._warped_memo = (key, warped)
        return warped

    def _global_xforms_snapshot(self, tile_idx: int) -> dict:
        """Global affine/origin/spacing, with the stage position as origin
        when no global transform is stored."""
        store = self._store
        xforms = store.global_xforms.get(tile_idx)
        if xforms is not None:
            affine, origin, spacing = (np.asarray(v, np.float64) for v in xforms)
        else:
            affine = np.eye(4)
            origin = np.asarray(store.stage_positions_zyx_um[tile_idx], np.float64)
            spacing = np.asarray(store.voxel_size_zyx_um, np.float64)
        return {
            "spacing": spacing,
            "origin": origin,
            "affine": affine,
            "camera_to_stage_affine": np.eye(4),
        }

    # ---------------------------------------------------- normalization
    def _global_normalization_vectors(
        self,
        low_percentile_cut: float = 10.0,
        high_percentile_cut: float = 90.0,
        hot_pixel_threshold: float = 50000.0,
        tile_indices: Optional[Sequence[int]] = None,
        lowpass_sigma=DEFAULT_DECODE_LOWPASS_SIGMA,
    ) -> None:
        """Percentile seeding of the normalization vectors over <= 5
        random tiles."""
        n_tiles = self._store.num_tiles
        if tile_indices is not None:
            tiles = list(tile_indices)
        elif n_tiles > 5:
            tiles = random.sample(range(n_tiles), 5)
        else:
            tiles = list(range(n_tiles))
        with profiling.span("decoder.seed"):
            norm, bg = seed_stats_program(
                [self._load_warped_bit_stack(t) for t in tiles],
                sigma=tuple(float(s) for s in lowpass_sigma),
                hot_threshold=float(hot_pixel_threshold),
                low_cut=float(low_percentile_cut),
                high_cut=float(high_percentile_cut),
            )
        self._global_normalization_vector = norm
        self._global_background_vector = bg
        self._store.save_normalization_vectors(norm, bg, run_key="global")

    def _prepare_normalization_state(self) -> tuple[np.ndarray, np.ndarray]:
        """iterative > global > identity."""
        if self._iterative_normalization_vector is not None:
            return self._iterative_normalization_vector, self._iterative_background_vector
        stored = self._store.load_normalization_vectors("iterative")
        if stored is not None:
            self._iterative_normalization_vector, self._iterative_background_vector = stored
            return stored
        if self._global_normalization_vector is not None:
            return self._global_normalization_vector, self._global_background_vector
        stored = self._store.load_normalization_vectors("global")
        if stored is not None:
            self._global_normalization_vector, self._global_background_vector = stored
            return stored
        n = self._n_merfish_bits
        return np.ones(n, np.float32), np.zeros(n, np.float32)

    def _iterative_normalization_vectors(self) -> None:
        """Per-bit medians of on-/off-bit intensities of the non-blank
        decoded transcripts → new normalization/background vectors (an
        empty decode shrinks the normalization 4x instead)."""
        table = self._barcodes_loaded
        if table_len(table):
            table = select_rows(table, ~is_blank(table["gene_id"]))
        n_bits = self._n_merfish_bits
        if self._iterative_normalization_vector is None:
            old_norm = np.round(self._global_normalization_vector[:n_bits], 1)
            old_bg = np.round(self._global_background_vector[:n_bits], 1)
        else:
            old_norm = np.asarray(self._iterative_normalization_vector)
            old_bg = np.asarray(self._iterative_background_vector)
        if not table_len(table):
            norm = np.maximum(old_norm / 4.0, 1e-3)
            bg = old_bg
        else:
            bm = np.stack(
                [np.asarray(table[f"bit{i:02d}_mean_intensity"], np.float64)
                 for i in range(1, n_bits + 1)], axis=1,
            )
            n_on = self._on_bits_1based.shape[1]
            on0 = np.stack(
                [np.asarray(table[f"on_bit_{i + 1}"], np.int64) for i in range(n_on)], axis=1
            ) - 1
            on_mask = np.zeros_like(bm, dtype=bool)
            np.put_along_axis(on_mask, on0, True, axis=1)
            with np.errstate(all="ignore"):
                norm = np.round(np.nanmedian(np.where(on_mask, bm, np.nan), axis=0), 1)
                bg = np.round(np.nanmedian(np.where(~on_mask, bm, np.nan), axis=0), 1)
            norm = np.nan_to_num(norm, nan=1.0)
            norm = np.where(norm == 0.0, 1.0, norm)
            bg = np.nan_to_num(bg, nan=0.0)
        self._iterative_normalization_vector = norm.astype(np.float32)
        self._iterative_background_vector = bg.astype(np.float32)
        self._store.save_normalization_vectors(
            self._iterative_normalization_vector,
            self._iterative_background_vector,
            run_key="iterative",
        )

    # --------------------------------------------------------------- decode
    def _device_decode(self, stack: torch.Tensor, *, lowpass_sigma, optimize: bool):
        """Lowpass + nearest-codeword decode of one tile's stack. Returns
        (decoded, magnitude, distance, intensities) as tensors on the
        device: the dense scaled traces for the final decode, the dense
        raw lowpassed intensities during normalization optimization."""
        norm, bg = self._prepare_normalization_state()
        nb = self._n_merfish_bits
        sigma = tuple(float(s) for s in lowpass_sigma)
        kw = dict(
            magnitude_threshold=self._magnitude_threshold,
            distance_threshold=self._pixel_distance_threshold,
            on_device=True,
        )
        if not optimize:
            return fused_decode_volume(
                stack, self._codebook_matrix, bg[:nb], norm[:nb], sigma=sigma, **kw
            )
        lp = gaussian_lowpass(stack, sigma=sigma)
        decoded, mag, dist, _ = decode_volume(
            lp, self._codebook_matrix, bg[:nb], norm[:nb], return_scaled=False, **kw
        )
        return decoded, mag, dist, lp

    def decode_one_tile(
        self, tile_idx: int, *, lowpass_sigma=DEFAULT_DECODE_LOWPASS_SIGMA,
        optimize_normalization_weights: bool = False,
    ) -> dict:
        with profiling.span("decoder.pass" if optimize_normalization_weights else "decoder.final"):
            stack = self._load_warped_bit_stack(tile_idx)
            decoded, mag, dist, intensity = self._device_decode(
                stack, lowpass_sigma=lowpass_sigma, optimize=optimize_normalization_weights
            )
            return self._extract_barcodes(
                decoded, mag, dist, intensity, tile_idx, self._global_xforms_snapshot(tile_idx)
            )

    def _extract_barcodes(
        self, decoded, magnitude, distance, intensity, tile_idx: int, state: dict
    ) -> dict:
        """Connected components + region features → decoded-features
        table, in the reference's column order."""
        with profiling.span("decoder.extract"):
            with profiling.span("decoder.extract.label"):
                labels = label_components(decoded)
            with profiling.span("decoder.extract.stats"):
                stats = component_stats_host(
                    decoded,
                    labels,
                    distance,
                    magnitude,
                    intensity,
                    collect_weighted_centroids=self._collect_chromatic_centroids,
                    size_window=(self._minimum_pixels, self._maximum_pixels),
                )
            del labels
            with profiling.span("decoder.extract.table"):
                return self._barcode_table(stats, tile_idx, state)

    def _barcode_table(self, stats: dict, tile_idx: int, state: dict) -> dict:
        """The decoded-features table of a tile's component statistics
        (the components within the size window, which
        ``component_stats_host`` applied), with their region features,
        global coordinates and signal columns."""
        area = stats["area"]
        if not len(area):
            return self._empty_barcode_table()
        centroid = stats["centroid_zyx"]
        codeword = stats["codeword"]
        bm = stats["bit_means"].T.astype(np.float64)  # (n, bits)
        eig = inertia_tensor_eigvals(stats["moments"], area)
        n_on = self._on_bits_1based.shape[1]
        on_sel = self._on_bits_1based[codeword]

        z, y, x = (centroid[:, i].astype(np.float64) for i in range(3))
        cols: dict[str, np.ndarray] = {
            "area": area.astype(np.float64), "z": z, "y": y, "x": x,
        }
        for i in range(3):
            cols[f"inertia_tensor_eigvals-{i}"] = eig[:, i].astype(np.float64)
        cols["distance_min"] = stats["distance_min"].astype(np.float64)
        cols["magnitude_mean"] = stats["magnitude_mean"].astype(np.float64)
        cols["barcode_id"] = codeword.astype(np.int32) + 1
        cols["gene_id"] = self._gene_ids[codeword]
        cols["tile_idx"] = np.full(len(area), int(tile_idx), np.int64)
        for i in range(n_on):
            cols[f"on_bit_{i + 1}"] = on_sel[:, i]
        for b in range(self._n_merfish_bits):
            cols[f"bit{b + 1:02d}_mean_intensity"] = bm[:, b]
        if self._collect_chromatic_centroids:
            cols.update(self._on_bit_centroid_columns(
                stats["bit_w_coord_sums"], stats["bit_sums"], on_sel
            ))
        cols["tile_z"] = np.round(z, 0).astype(np.int64)
        cols["tile_y"] = np.round(y, 0).astype(np.int64)
        cols["tile_x"] = np.round(x, 0).astype(np.int64)
        pts = self._warp_pixels(np.stack([z, y, x], axis=1), state)
        cols["global_z"] = np.round(pts[:, 0], 2)
        cols["global_y"] = np.round(pts[:, 1], 2)
        cols["global_x"] = np.round(pts[:, 2], 2)
        signal = np.take_along_axis(bm, on_sel - 1, axis=1).sum(axis=1)
        signal_mean = signal / float(n_on)
        bkd_mean = (bm.sum(axis=1) - signal) / float(self._n_merfish_bits - n_on)
        cols["signal_mean"] = signal_mean
        cols["bkd_mean"] = bkd_mean
        cols["s-b_mean"] = signal_mean - bkd_mean
        return select_rows(cols, cols["distance_min"] <= self._transcript_distance_threshold)

    def _on_bit_centroid_columns(self, w_coord_sums, bit_sums, on_sel) -> dict:
        """Sparse per-on-bit intensity-weighted centroid columns
        ``bitNN_center_z/y/x`` (px) and ``bitNN_intensity_sum``: NaN except
        at a transcript's on-bits whose intensity sum exceeds the config's
        epsilon."""
        n_rows = on_sel.shape[0]
        nb = self._n_merfish_bits
        eps = self._chromatic_affine_config.centroid_weight_epsilon
        centers = np.full((nb, n_rows, 3), np.nan)
        wsums = np.full((nb, n_rows), np.nan)
        rows = np.arange(n_rows)
        for col in range(on_sel.shape[1]):
            bits0 = on_sel[:, col].astype(np.intp) - 1
            w = bit_sums[bits0, rows]
            ok = w > eps
            centers[bits0[ok], rows[ok]] = w_coord_sums[bits0[ok], rows[ok]] / w[ok, None]
            wsums[bits0[ok], rows[ok]] = w[ok]
        cols = {}
        for b in range(nb):
            for i, axis in enumerate("zyx"):
                cols[f"bit{b + 1:02d}_center_{axis}"] = centers[b, :, i]
            cols[f"bit{b + 1:02d}_intensity_sum"] = wsums[b]
        return cols

    @staticmethod
    def _warp_pixels(pts: np.ndarray, state: dict) -> np.ndarray:
        """pixel → µm → camera-to-stage → global affine."""
        out = pts * state["spacing"][None, :] + state["origin"][None, :]
        homo = np.concatenate([out, np.ones((len(out), 1))], axis=1)
        out = (state["camera_to_stage_affine"] @ homo.T).T[:, :3]
        homo = np.concatenate([out, np.ones((len(out), 1))], axis=1)
        return (state["affine"] @ homo.T).T[:, :3]

    def _empty_barcode_table(self) -> dict:
        names = (
            ["area", "z", "y", "x"]
            + [f"inertia_tensor_eigvals-{i}" for i in range(3)]
            + ["distance_min", "magnitude_mean", "barcode_id", "gene_id", "tile_idx"]
            + [f"on_bit_{i + 1}" for i in range(self._on_bits_1based.shape[1])]
            + [f"bit{b + 1:02d}_mean_intensity" for b in range(self._n_merfish_bits)]
            + ["tile_z", "tile_y", "tile_x", "global_z", "global_y", "global_x"]
            + ["signal_mean", "bkd_mean", "s-b_mean"]
        )
        return {n: np.zeros(0, object if n == "gene_id" else np.float64) for n in names}

    # ------------------------------------------- normalization optimization
    def optimize_normalization_by_decoding(
        self,
        n_random_tiles: int = 20,
        n_iterations: int = 5,
        *,
        minimum_pixels: Optional[float] = None,
        lowpass_sigma=DEFAULT_DECODE_LOWPASS_SIGMA,
    ) -> None:
        """Seed the global vectors, then alternate decoding the sampled
        tiles and re-estimating the vectors from the decoded transcripts.
        Each iteration's tables are kept in the store's checkpoints. With
        chromatic estimation, the calibration starts at identity and is
        re-estimated from each pass's transcripts before the vectors."""
        store = self._store
        if minimum_pixels is not None:
            self._minimum_pixels = float(minimum_pixels)
        n_tiles = store.num_tiles
        sample_idx = (
            sorted(random.sample(range(n_tiles), n_random_tiles))
            if n_tiles > n_random_tiles
            else list(range(n_tiles))
        )
        if self._estimate_chromatic:
            save_identity_chromatic_affines(store, self._n_merfish_bits)
            self._collect_chromatic_centroids = True
        self._global_normalization_vectors(
            tile_indices=sample_idx[:5], lowpass_sigma=lowpass_sigma
        )
        for it in range(n_iterations):
            frames = [
                self.decode_one_tile(
                    t, lowpass_sigma=lowpass_sigma, optimize_normalization_weights=True
                )
                for t in sample_idx
            ]
            store.iteration_checkpoints[it] = frames
            self._barcodes_loaded = concat_tables(frames)
            if self._estimate_chromatic and table_len(self._barcodes_loaded):
                with profiling.span("decoder.chromatic"):
                    estimate_chromatic_affines_from_barcodes(
                        store, self._barcodes_loaded, n_merfish_bits=self._n_merfish_bits,
                        config=self._chromatic_affine_config,
                    )
            with profiling.span("decoder.vectors"):
                self._iterative_normalization_vectors()
        self._collect_chromatic_centroids = False

    # -------------------------------------------------------- full pipeline
    def decode_all_tiles(
        self,
        *,
        lowpass_sigma=DEFAULT_DECODE_LOWPASS_SIGMA,
        filter_method: str = "blank_fraction",
        target_misid_rate: float = 0.05,
    ) -> dict:
        """Decode every tile, store each tile's table, then filter and
        store the global filtered table."""
        store = self._store
        if store.num_tiles != 1:
            raise NotImplementedError(
                "tile-overlap duplicate removal is not ported; one tile only"
            )
        for t in range(store.num_tiles):
            store.decoded_tables[t] = self.decode_one_tile(t, lowpass_sigma=lowpass_sigma)
        self._warped_memo = None  # release the device stack
        table = concat_tables([store.decoded_tables[t] for t in range(store.num_tiles)])
        self._barcodes_loaded = table
        with profiling.span("decoder.filter"):
            table = self._apply_filter_method(table, filter_method, target_misid_rate)
        store.filtered_table = table
        return table

    def _apply_filter_method(self, table: dict, method: str, target_misid_rate: float) -> dict:
        if not table_len(table) or method in (None, "none"):
            return table
        if method != "blank_fraction":
            raise NotImplementedError(f"filter method {method!r} is not ported")
        self.last_filter_diagnostics: dict = {}
        return filter_blank_fraction(
            table,
            n_blank_codewords=int(self._blank_mask.sum()),
            n_total_codewords=len(self._gene_ids),
            target_misid_rate=target_misid_rate,
            diagnostics_out=self.last_filter_diagnostics,
        )
