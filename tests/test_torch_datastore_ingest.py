"""``convert_data``'s readout-bit ingest, on CPU.

uint16 bits are stored as read-only views of ``raw.bits``: byte-equal to
the reference's float32 clip, sharing the caller's memory, counted once
an image by ``datastore.clip.passthrough``. With chromatic injection the
store takes one private copy and leaves ``raw.bits`` alone. Bits of any
other dtype are refused.
"""

import dataclasses

import numpy as np
import pytest

from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import generate_raw_experiment
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.utils import profiling

N_TILES, N_BITS, SHAPE = 2, 16, (4, 24, 24)


def _clip(bits: np.ndarray) -> np.ndarray:
    return np.clip(bits.astype(np.float32), 0, 65535).astype(np.uint16)


def _raw(case: str, seed: int):
    """A small acquisition of ``N_TILES`` tiles whose bits are seeded
    noise over the whole range of their dtype: uint16 with 0 and 65535
    present, or float32 with negatives, values above 65535 and fractions."""
    raw = generate_raw_experiment(shape=SHAPE, n_bits=N_BITS, n_spots=8, n_tiles=N_TILES,
                                  tile_offset_px=(0.0, 16.0, 16.0), seed=seed)
    rng = np.random.default_rng(seed)
    shape = raw.bits.shape
    if case == "float32":
        bits = rng.uniform(-2000.0, 70000.0, shape).astype(np.float32)
        bits.flat[:4] = (-0.5, 65535.75, 65536.0, 12.25)
    else:
        bits = rng.integers(0, 65536, shape, dtype=np.uint16)
        bits.flat[:2] = (0, 65535)
    return dataclasses.replace(raw, bits=bits)


@pytest.fixture
def tracing():
    profiling.enable()
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
@pytest.mark.parametrize("case", ["uint16", "inject", "float32"])
def test_ingest_stores_the_clip_bytes(tracing, case, seed):
    raw = _raw(case, seed)
    assert raw.bits.shape[:2] == (N_TILES, N_BITS)
    before = raw.bits.copy()
    if case == "float32":
        with pytest.raises(TypeError, match="corrected images must be uint16"):
            convert_data(raw, device="cpu")
        np.testing.assert_array_equal(raw.bits, before)
        assert raw.bits.flags.writeable
        return
    store = convert_data(raw, inject_chromatic_aberration=case == "inject", device="cpu")
    np.testing.assert_array_equal(raw.bits, before)
    stored = [store.corrected[(t, b)] for t in range(N_TILES) for b in range(N_BITS)]
    assert all(img.dtype == np.uint16 for img in stored)
    shared = [np.shares_memory(img, raw.bits) for img in stored]
    assert all(shared) if case == "uint16" else not any(shared)
    if case == "inject":
        assert all(img.flags.writeable for img in stored)
        # the reference wavelength's bits are stored unwarped: the clip's bytes
        reference_wl = min(float(w[1]) for w in raw.bit_wavelengths_um)
        kept = [b for b, w in enumerate(raw.bit_wavelengths_um) if np.isclose(w[1], reference_wl)]
        assert kept and len(kept) < N_BITS
        for t in range(N_TILES):
            for b in kept:
                assert store.corrected[(t, b)].tobytes() == _clip(before[t, b]).tobytes()
    else:
        want = _clip(before)
        for t in range(N_TILES):
            for b in range(N_BITS):
                assert store.corrected[(t, b)].tobytes() == want[t, b].tobytes()
    if case == "uint16":
        assert all(not img.flags.writeable for img in stored)
        assert raw.bits.flags.writeable
        with pytest.raises(ValueError):
            store.corrected[(0, 0)][0, 0, 0] = 1
    counters = profiling.snapshot()["counters"]
    passthrough = counters.get("datastore.clip.passthrough", {"total": 0, "by_span": {}})
    assert passthrough["total"] == (N_TILES * N_BITS if case == "uint16" else 0)
    if case == "uint16":
        assert passthrough["by_span"] == {"datastore.clip": N_TILES * N_BITS}
