"""In-memory stand-in for the subset of ``qi2labDataStore`` that the
port's decode slice reads and writes.

The reference datastore is zarr3 + blosc/zstd via tensorstore with
pandas/parquet tables; the port depends on torch, numpy and scipy only,
so it keeps its state in numpy arrays. :meth:`ArrayStore.from_arrays`
is also how a test hands the reference datastore's exact state to the
port.

Readout images are keyed by integer ``(tile, bit)``; fiducial images,
round transforms and deformable flow fields by ``(tile, round)``;
``round_of_bit`` links each bit to its 0-based round. A flow field is
``(field (3, fz, fy, fx) float32, attrs)`` with the reference's attribute
names (``map_stride_zyx_px``, ``map_box_start_xyz_px``,
``map_box_size_xyz_px``, ``reference_shape_zyx_px``,
``moving_shape_zyx_px``, ``sofima_status``, ``valid_flow_vectors``). ``channel_psfs`` holds one PSF per channel, the
fiducial channel first and then the readout emission wavelengths in
order, with the objective's ``na`` and immersion ``ri``; registration
deconvolves with them.
Tables are ``dict[str, np.ndarray]`` of equal-length columns. The
chromatic calibration is the reference's JSON payload, kept as the JSON
round trip of what was saved.
"""

from __future__ import annotations

import itertools
import json
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np


def _maybe_float(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _json_safe(value: Any) -> Any:
    """numpy scalars and arrays as JSON types."""
    if isinstance(value, np.ndarray):
        return [_json_safe(v) for v in value.tolist()]
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return value


class _VersionedDict(dict):
    """A dict whose ``version`` counts the writes to it."""

    version = 0

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.version += 1

    def __delitem__(self, key):
        super().__delitem__(key)
        self.version += 1

    def _bump(name):
        def method(self, *args, **kwargs):
            out = getattr(dict, name)(self, *args, **kwargs)
            self.version += 1
            return out
        return method

    update = _bump("update")
    pop = _bump("pop")
    popitem = _bump("popitem")
    clear = _bump("clear")
    setdefault = _bump("setdefault")
    del _bump


# run ids: one a store, for the tracing spans of the work done on it
_RUN_IDS = itertools.count()


class ArrayStore:
    def __init__(
        self,
        *,
        gene_ids,
        codebook_matrix: np.ndarray,  # (words, bits) 0/1
        num_tiles: int,
        voxel_size_zyx_um,
        round_of_bit,  # (bits,) 0-based round index per bit
        bit_wavelengths_um,  # (bits, 2) excitation, emission
        stage_positions_zyx_um,  # (tiles, 3)
        channel_psfs=(),  # per channel (Z, Y, X) float32: fiducial, then readouts
        na: float = 1.35,
        ri: float = 1.4,
    ):
        self.run_id = next(_RUN_IDS)
        self.gene_ids = [str(g) for g in gene_ids]
        self.codebook_matrix = np.asarray(codebook_matrix, np.float32)
        self.num_tiles = int(num_tiles)
        self.voxel_size_zyx_um = np.asarray(voxel_size_zyx_um, np.float64)
        self.round_of_bit = np.asarray(round_of_bit, np.int64)
        self.bit_wavelengths_um = np.asarray(bit_wavelengths_um, np.float64)
        self.stage_positions_zyx_um = np.asarray(stage_positions_zyx_um, np.float64)
        self.channel_psfs = [np.asarray(p, np.float32) for p in channel_psfs]
        self.na = float(na)
        self.ri = float(ri)
        self.num_bits = int(self.codebook_matrix.shape[1])
        self.num_rounds = int(self.round_of_bit.max()) + 1
        self.corrected: dict[tuple[int, int], np.ndarray] = {}  # u16
        self.fiducial_corrected: dict[tuple[int, int], np.ndarray] = {}  # u16
        self.fiducial_registered: dict[tuple[int, int], np.ndarray] = {}  # u16
        self.registered: dict[tuple[int, int], np.ndarray] = {}  # u16
        self.feature_predictor: dict[tuple[int, int], np.ndarray] = {}  # u8 k/255
        self.round_transforms: dict[tuple[int, int], np.ndarray] = {}  # 4x4 µm
        self.global_xforms: dict[int, tuple] = {}  # (affine, origin, spacing)
        # (field, attrs) by (tile, round); its version counts the writes, so
        # that a warped stack built before one is known to be stale
        self.flow_fields: dict[tuple[int, int], tuple] = _VersionedDict()
        self.chromatic_calibration: dict = {}
        self.chromatic_diagnostics: Optional[dict] = None
        # bumped by every calibration save: a warped stack built before it is stale
        self.chromatic_version = 0
        # the affine convert_data injected, as the reference's injected_chromatic_affine.json
        self.injected_chromatic_affine: Optional[np.ndarray] = None
        self.normalization_vectors: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self.iteration_checkpoints: dict[int, list[dict]] = {}
        self.decoded_tables: dict[int, dict] = {}
        self.filtered_table: Optional[dict] = None

    @classmethod
    def from_arrays(
        cls,
        *,
        gene_ids,
        codebook_matrix,
        voxel_size_zyx_um,
        round_of_bit,
        bit_wavelengths_um,
        stage_positions_zyx_um,
        corrected=None,  # (tiles, bits, Z, Y, X) u16
        fiducial_corrected=None,  # (tiles, rounds, Z, Y, X) u16
        registered=None,  # (tiles, bits, Z, Y, X) u16
        feature_predictor=None,  # (tiles, bits, Z, Y, X) u8
        round_transforms=None,  # (tiles, rounds, 4, 4)
        global_xforms=None,  # per tile (affine, origin, spacing)
        flow_fields=None,  # {(tile, round): (field (3, fz, fy, fx), attrs)}
        channel_psfs=(),
        na: float = 1.35,
        ri: float = 1.4,
    ) -> "ArrayStore":
        """Build a store from stacked arrays (any of the image sets may
        be absent)."""
        num_tiles = len(np.asarray(stage_positions_zyx_um).reshape(-1, 3))
        store = cls(
            gene_ids=gene_ids,
            codebook_matrix=codebook_matrix,
            num_tiles=num_tiles,
            voxel_size_zyx_um=voxel_size_zyx_um,
            round_of_bit=round_of_bit,
            bit_wavelengths_um=bit_wavelengths_um,
            stage_positions_zyx_um=np.asarray(stage_positions_zyx_um).reshape(-1, 3),
            channel_psfs=channel_psfs,
            na=na,
            ri=ri,
        )
        for name, arrays, dtype, count in (
            ("corrected", corrected, np.uint16, store.num_bits),
            ("registered", registered, np.uint16, store.num_bits),
            ("feature_predictor", feature_predictor, np.uint8, store.num_bits),
            ("fiducial_corrected", fiducial_corrected, np.uint16, store.num_rounds),
        ):
            if arrays is None:
                continue
            target = getattr(store, name)
            for t in range(num_tiles):
                for b in range(count):
                    arr = np.asarray(arrays[t][b])
                    if arr.dtype != dtype:
                        raise TypeError(f"{name} images must be {np.dtype(dtype)}, got {arr.dtype}")
                    target[(t, b)] = arr
        if round_transforms is not None:
            for t in range(num_tiles):
                for r in range(store.num_rounds):
                    store.round_transforms[(t, r)] = np.asarray(
                        round_transforms[t][r], np.float64
                    )
        if global_xforms is not None:
            for t in range(num_tiles):
                store.global_xforms[t] = tuple(
                    np.asarray(v, np.float64) for v in global_xforms[t]
                )
        for (t, r), (field, attrs) in (flow_fields or {}).items():
            store.save_local_sofima_flow_field(field, tile=t, round=r, **attrs)
        return store

    # ---------------------------------------------------------- images
    def registered_stack(self, tile: int) -> tuple[np.ndarray, np.ndarray]:
        """(bits, Z, Y, X) u16 registered images and u8 probabilities."""
        bits = range(self.num_bits)
        missing = [b for b in bits if (tile, b) not in self.registered
                   or (tile, b) not in self.feature_predictor]
        if missing:
            raise KeyError(f"tile {tile}: no registered image or probability for bits {missing}")
        return (
            np.stack([self.registered[(tile, b)] for b in bits]),
            np.stack([self.feature_predictor[(tile, b)] for b in bits]),
        )

    # ---------------------------------------------------------- transforms
    def round_transform(self, tile: int, round_idx: int) -> np.ndarray:
        if (tile, round_idx) not in self.round_transforms:
            raise KeyError(f"missing round transform for tile={tile} round={round_idx}")
        return self.round_transforms[(tile, round_idx)]

    @property
    def flow_version(self) -> int:
        """Writes to ``flow_fields`` so far."""
        return self.flow_fields.version

    def save_local_sofima_flow_field(
        self,
        field,
        *,
        tile: int,
        round: int,
        map_stride_zyx_px,
        map_box_start_xyz_px,
        map_box_size_xyz_px,
        reference_shape_zyx_px,
        moving_shape_zyx_px=None,
        sofima_status: str = "ok",
        valid_flow_vectors: int = 0,
        **extra,
    ) -> None:
        """Store a (3, fz, fy, fx) float32 flow field of ``(tile, round)``
        with its attributes in the reference's JSON types."""
        field = np.asarray(field, np.float32)
        if field.ndim != 4 or field.shape[0] != 3:
            raise ValueError(f"a flow field is (3, fz, fy, fx), got {field.shape}")
        attrs = {
            "map_stride_zyx_px": [float(v) for v in map_stride_zyx_px],
            "map_box_start_xyz_px": [float(v) for v in map_box_start_xyz_px],
            "map_box_size_xyz_px": [float(v) for v in map_box_size_xyz_px],
            "reference_shape_zyx_px": [int(v) for v in reference_shape_zyx_px],
            "sofima_status": str(sofima_status),
            "valid_flow_vectors": int(valid_flow_vectors),
        }
        if moving_shape_zyx_px is not None:
            attrs["moving_shape_zyx_px"] = [int(v) for v in moving_shape_zyx_px]
        attrs.update(json.loads(json.dumps(_json_safe(extra))))
        self.flow_fields[(int(tile), int(round))] = (field.copy(), attrs)

    def load_local_sofima_flow_field(self, tile: int, round: int):
        """(field, attrs) of ``(tile, round)``, or None."""
        return self.flow_fields.get((int(tile), int(round)))

    def chromatic_transform(self, emission_um: float) -> np.ndarray:
        """The stored chromatic affine of an emission wavelength (float32),
        identity without one."""
        return self.load_chromatic_affine_transform_zyx_um(wavelength_um=emission_um)

    # ---------------------------------------------------------- chromatic
    def save_chromatic_affine_transforms_zyx_um(
        self, calibration: Mapping[str, Any], diagnostics: Optional[dict] = None
    ) -> None:
        """Per-channel 4x4 physical chromatic affines. Structured payload
        ``{"channels": {name: {"channel_index", "wavelength_um",
        "affine_zyx_um"}}}``; a flat ``{name: 4x4}`` mapping is normalized
        to it, the name read as the wavelength where it is a number."""
        calibration = dict(calibration)
        if "channels" not in calibration:
            calibration = {
                "channels": {
                    str(k): {
                        "channel_index": i,
                        "wavelength_um": _maybe_float(k),
                        "affine_zyx_um": np.asarray(v, dtype=np.float64).reshape(4, 4).tolist(),
                    }
                    for i, (k, v) in enumerate(calibration.items())
                }
            }
        self.chromatic_calibration = json.loads(json.dumps(_json_safe(calibration)))
        if diagnostics is not None:
            self.chromatic_diagnostics = json.loads(json.dumps(_json_safe(diagnostics)))
        self.chromatic_version += 1

    def load_chromatic_affine_transforms_zyx_um(self) -> dict[str, Any]:
        """The structured calibration payload (may be {})."""
        return dict(self.chromatic_calibration)

    def load_chromatic_affine_transform_zyx_um(
        self,
        channel_name: Optional[str] = None,
        channel_index: Optional[int] = None,
        wavelength_um: Optional[float] = None,
    ) -> np.ndarray:
        """One chromatic affine (float32): the channels matching by name,
        then by index, then by ``np.isclose`` on the wavelength; the first
        with an affine wins, identity when none has one."""
        channels = self.chromatic_calibration.get("channels", {})
        if not isinstance(channels, Mapping):
            return np.eye(4, dtype=np.float32)
        candidates = []
        if channel_name is not None and str(channel_name) in channels:
            candidates.append(channels[str(channel_name)])
        if channel_index is not None:
            candidates += [ch for ch in channels.values() if isinstance(ch, Mapping)
                           and int(ch.get("channel_index", -1)) == int(channel_index)]
        if wavelength_um is not None:
            candidates += [ch for ch in channels.values() if isinstance(ch, Mapping)
                           and ch.get("wavelength_um") is not None
                           and np.isclose(float(ch["wavelength_um"]), float(wavelength_um))]
        for ch in candidates:
            if ch.get("affine_zyx_um") is not None:
                return np.asarray(ch["affine_zyx_um"], dtype=np.float32)
        return np.eye(4, dtype=np.float32)

    # ---------------------------------------------------------- vectors
    def save_normalization_vectors(self, norm, bg, run_key: str) -> None:
        self.normalization_vectors[run_key] = (
            np.asarray(norm, np.float32).copy(), np.asarray(bg, np.float32).copy()
        )

    def load_normalization_vectors(self, run_key: str):
        return self.normalization_vectors.get(run_key)
