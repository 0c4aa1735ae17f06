"""Pixel decoding with the simulation defaults (counterpart of
``decode_pixels`` in ``merfish3d_tpu/cli/simulation/pixeldecode.py``):
magnitude window (0.9, 10.0), minimum component size 28 voxels (3D
simulation), blank-fraction filter; optionally the decode-time chromatic
estimate. The port's entry point."""

from __future__ import annotations

from ...datastore.array_store import ArrayStore
from ...pipeline.decoder import PixelDecoder
from ...utils import profiling

SIM_DEFAULT_MAGNITUDE_THRESHOLD = (0.9, 10.0)
SIM_3D_DEFAULT_MINIMUM_PIXELS = 28


def decode_pixels(
    store: ArrayStore,
    *,
    device="cuda",
    minimum_pixels: int = SIM_3D_DEFAULT_MINIMUM_PIXELS,
    magnitude_threshold=SIM_DEFAULT_MAGNITUDE_THRESHOLD,
    num_tiles: int = 20,
    num_iterations: int = 3,
    filter_method: str = "blank_fraction",
    target_misid_rate: float = 0.05,
    estimate_chromatic_affines: bool = False,
    lowpass_sigma=(3.0, 1.0, 1.0),
) -> dict:
    """Normalization optimization (with ``estimate_chromatic_affines``,
    the chromatic affines estimated after each pass and saved to the
    store), then the final decode and filter. Returns the filtered
    decoded-features table."""
    with profiling.span("decoder.decode_pixels", run=store.run_id):
        decoder = PixelDecoder(
            store,
            device=device,
            magnitude_threshold=tuple(magnitude_threshold),
            minimum_pixels=minimum_pixels,
            estimate_chromatic_affines=estimate_chromatic_affines,
        )
        decoder.optimize_normalization_by_decoding(
            n_random_tiles=num_tiles,
            n_iterations=num_iterations,
            lowpass_sigma=tuple(lowpass_sigma),
        )
        return decoder.decode_all_tiles(
            lowpass_sigma=tuple(lowpass_sigma),
            filter_method=filter_method,
            target_misid_rate=target_misid_rate,
        )
