"""Component extraction on tensors (merfish3d_tpu_torch/ops/components.py)
against the JAX package, on CPU.

The plain torch labeller gives the native labeller's components
(``native.label_components_sparse``) in the native labeller's order, and
the JAX package's ``label_connected`` roots; the plain torch sums give
the JAX package's ``component_stats_host`` statistics bit for bit, with
and without weighted centroids and the size window; the decode functions' device
returns equal their host returns; and every extraction of a CPU
``PixelDecoder``'s passes and final decode gives the JAX package's
statistics of the same decode.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfish3d_tpu.ops.cc import component_stats_host as jax_component_stats_host
from merfish3d_tpu.ops.cc import label_connected as jax_label_connected
from merfish3d_tpu_torch import native
from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import generate_raw_experiment
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.ops import components as comp
from merfish3d_tpu_torch.ops.cc import component_stats_host
from merfish3d_tpu_torch.ops.decode import decode_volume
from merfish3d_tpu_torch.ops.fused_decode import fused_decode_volume
from merfish3d_tpu_torch.pipeline import decoder as decoder_module
from merfish3d_tpu_torch.pipeline.decoder import PixelDecoder
from merfish3d_tpu_torch.pipeline.registration import DataRegistration
from merfish3d_tpu_torch.utils import profiling
from torch_extract_cases import CASES, native_roots, random_volume
from torch_port_common import mhd4_codebook


@pytest.mark.parametrize("name", list(CASES))
def test_plain_labeller_matches_native_and_jax(name):
    decoded = CASES[name]
    lin, roots = comp.label_components(torch.as_tensor(decoded))
    want_lin, want_roots = native_roots(decoded)
    np.testing.assert_array_equal(lin.numpy(), want_lin)
    np.testing.assert_array_equal(roots.numpy(), want_roots)
    volume = comp.label_volume_plain(torch.as_tensor(decoded))
    np.testing.assert_array_equal(volume.numpy(), np.asarray(jax_label_connected(jnp.asarray(decoded))))


def _inputs(decoded, bits=6, half=False, seed=0):
    """Distance and magnitude in float16, and (bits, Z, Y, X) intensities of
    wide dynamic range, so any change of summation order shows."""
    rng = np.random.default_rng(seed)
    shape = decoded.shape
    dist = rng.random(shape).astype(np.float16)
    mag = (rng.random(shape) * 4).astype(np.float16)
    spread = 1.5 if half else 4.0  # float16 ends at 65504
    vals = rng.standard_normal((bits, *shape)) * np.exp(rng.standard_normal((bits, *shape)) * spread)
    return dist, mag, vals.astype(np.float16 if half else np.float32)


def _select(stats: dict, keep: np.ndarray) -> dict:
    """The statistics of the components ``keep`` selects."""
    per_bit = ("bit_means", "bit_sums", "bit_w_coord_sums")
    return {k: v[:, keep] if k in per_bit else v[keep] for k, v in stats.items()}


def _assert_same_stats(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("window", [None, (4.0, 40.0)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("half", [False, True])
def test_plain_sums_match_host_bit_for_bit(weighted, window, half):
    decoded = random_volume((6, 30, 40), fg=0.4, words=3, seed=3)
    dist, mag, vals = _inputs(decoded, half=half)
    want = jax_component_stats_host(
        decoded.astype(np.int32), native.label_components_sparse(decoded.astype(np.int32)),
        dist.astype(np.float32), mag.astype(np.float32), vals.astype(np.float32),
        collect_weighted_centroids=weighted,
    )
    if window is not None:
        keep = (want["area"] >= window[0]) & (want["area"] <= window[1])
        assert 0 < keep.sum() < keep.size
        want = _select(want, keep)
    t = torch.as_tensor(decoded)
    got = component_stats_host(
        t, comp.label_components(t), torch.as_tensor(dist), torch.as_tensor(mag),
        torch.as_tensor(vals), collect_weighted_centroids=weighted, size_window=window,
    )
    _assert_same_stats(got, want)


def test_host_window_selects_the_rows_of_the_whole_table():
    decoded = random_volume((4, 20, 20), fg=0.4, words=2, seed=4)
    dist, mag, vals = _inputs(decoded, bits=3)
    whole = jax_component_stats_host(
        decoded.astype(np.int32), native.label_components_sparse(decoded.astype(np.int32)),
        dist.astype(np.float32), mag.astype(np.float32), vals, collect_weighted_centroids=True,
    )
    t = torch.as_tensor(decoded)
    part = component_stats_host(t, comp.label_components(t), torch.as_tensor(dist), torch.as_tensor(mag),
                                torch.as_tensor(vals), collect_weighted_centroids=True, size_window=(3, 10))
    keep = (whole["area"] >= 3) & (whole["area"] <= 10)
    assert 0 < keep.sum() < keep.size
    _assert_same_stats(part, _select(whole, keep))


@pytest.mark.parametrize("window", [None, (1000.0, 2000.0)])
def test_tensor_route_with_no_rows(window):
    """An empty foreground, or a window that keeps nothing: zero rows of
    every statistic, as the JAX package's statistics give with the window
    applied, and the component count still counted."""
    decoded = CASES["empty"] if window is None else random_volume((3, 8, 8), fg=0.3, seed=5)
    dist, mag, vals = _inputs(decoded, bits=4)
    labels = native.label_components_sparse(decoded.astype(np.int32))
    want = jax_component_stats_host(decoded.astype(np.int32), labels, dist.astype(np.float32),
                                    mag.astype(np.float32), vals, collect_weighted_centroids=True)
    if window is not None:
        want = _select(want, (want["area"] >= window[0]) & (want["area"] <= window[1]))
    t = torch.as_tensor(decoded)
    profiling.enable()
    profiling.reset()
    try:
        got = component_stats_host(t, comp.label_components(t), torch.as_tensor(dist), torch.as_tensor(mag),
                                   torch.as_tensor(vals), collect_weighted_centroids=True, size_window=window)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert got["area"].shape == (0,) and got["bit_sums"].shape == (4, 0)
    assert got["bit_w_coord_sums"].shape == (4, 0, 3) and got["moments"].shape == (0, 6)
    # the JAX package's empty-foreground table lists its keys in another order
    assert sorted(got) == sorted(want)
    _assert_same_stats({k: got[k] for k in want}, want)
    n_components = np.unique(labels[1]).size
    assert counters.get("extract.components", {}).get("total", 0) == n_components
    assert not any(k.startswith("launch.") for k in counters)


def test_sums_refuse_bad_input():
    decoded = torch.as_tensor(random_volume((2, 4, 4), seed=6))
    f16 = torch.zeros((2, 4, 4), dtype=torch.float16)
    vals = torch.zeros((3, 2, 4, 4))
    labels = comp.label_components(decoded)
    with pytest.raises(ValueError):
        comp.component_sums(decoded.to(torch.int32), labels, f16, f16, vals)
    with pytest.raises(ValueError):
        comp.component_sums(decoded, labels, f16.float(), f16, vals)
    with pytest.raises(ValueError):
        comp.component_sums(decoded, labels, f16, f16, vals[:, :1])
    with pytest.raises(ValueError):
        comp.label_components(decoded[None])


def _decode_inputs(shape=(16, 6, 24, 20), seed=7):
    rng = np.random.default_rng(seed)
    vol = (rng.random(shape) * 3).astype(np.float32)
    return vol, mhd4_codebook(), np.full(16, 0.2, np.float32), np.full(16, 1.1, np.float32)


@pytest.mark.parametrize("return_scaled", [False, True])
def test_decode_volume_on_device_matches_host(return_scaled):
    vol, cb, bg, nm = _decode_inputs()
    kw = dict(distance_threshold=0.6, magnitude_threshold=(0.5, 10.0), z_chunk=4,
              return_scaled=return_scaled, device="cpu")
    host = decode_volume(vol, cb, bg, nm, **kw)
    dev = decode_volume(vol, cb, bg, nm, on_device=True, **kw)
    for h, d in zip(host, dev):
        if h is None:
            assert d is None
        else:
            assert isinstance(d, torch.Tensor)
            np.testing.assert_array_equal(d.numpy(), h)


@pytest.mark.parametrize("slabs", [False, True])
def test_fused_decode_on_device_matches_host(slabs):
    vol, cb, bg, nm = _decode_inputs(seed=8)
    kw = dict(distance_threshold=0.6, magnitude_threshold=(0.5, 10.0), device="cpu")
    if slabs:
        kw.update(y_slab=8, memory_budget_bytes=0)
    host = fused_decode_volume(vol, cb, bg, nm, **kw)
    dev = fused_decode_volume(vol, cb, bg, nm, on_device=True, **kw)
    for h, d in zip(host, dev):
        assert isinstance(d, torch.Tensor)
        np.testing.assert_array_equal(d.numpy(), h)


@pytest.fixture(scope="module")
def registered_store():
    raw = generate_raw_experiment(shape=(12, 96, 96), seed=11, distribution="cells")
    store = convert_data(raw, device="cpu")
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False,
                     ufish_model="dog").register_all_tiles()
    return store


def _decode_with_jax_statistics(store, *, chromatic: bool):
    """A CPU decoder's two passes and final decode, each extraction's
    statistics held, bit for bit, to the JAX package's
    ``component_stats_host`` on host copies of the same inputs, with the
    native labeller's labels and the size window applied. Returns the
    tables, the counters and the number of extractions."""
    calls = []

    def checked(decoded, labels, distance, magnitude, scaled, *, collect_weighted_centroids, size_window):
        got = component_stats_host(decoded, labels, distance, magnitude, scaled,
                                   collect_weighted_centroids=collect_weighted_centroids,
                                   size_window=size_window)
        dec32 = decoded.numpy().astype(np.int32)
        want = jax_component_stats_host(
            dec32, native.label_components_sparse(dec32), distance.numpy().astype(np.float32),
            magnitude.numpy().astype(np.float32), scaled.numpy().astype(np.float32),
            collect_weighted_centroids=collect_weighted_centroids,
        )
        want = _select(want, (want["area"] >= size_window[0]) & (want["area"] <= size_window[1]))
        assert len(want["area"]) > 20
        _assert_same_stats({k: got[k] for k in want}, want)
        assert sorted(got) == sorted(want)
        calls.append(collect_weighted_centroids)
        return got

    decoder = PixelDecoder(store, device="cpu", minimum_pixels=4, magnitude_threshold=(0.9, 10.0),
                           estimate_chromatic_affines=chromatic)
    profiling.enable()
    profiling.reset()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(decoder_module, "component_stats_host", checked)
            decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=2)
            filtered = decoder.decode_all_tiles()
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    passes = [store.iteration_checkpoints[it][0] for it in sorted(store.iteration_checkpoints)]
    return [*passes, store.decoded_tables[0], filtered], counters, calls


@pytest.mark.parametrize("chromatic", [False, True])
def test_decoder_extraction_matches_jax_statistics(registered_store, chromatic):
    """Every extraction of a CPU decoder (two passes and the final decode,
    with and without the chromatic centroids) runs the tensor route the
    card runs, here on the plain versions, and its statistics equal the
    JAX package's on the same decode; only the window's rows come down."""
    tables, counters, calls = _decode_with_jax_statistics(copy.deepcopy(registered_store),
                                                          chromatic=chromatic)
    assert calls == [chromatic, chromatic, False]
    assert len(tables) == 4 and all(len(t["area"]) > 20 for t in tables)
    if chromatic:
        assert "bit01_center_z" in tables[0]
    assert counters["extract.components"]["total"] >= sum(len(t["area"]) for t in tables[:3])
    # the decode's outputs never cross: only the window's rows come down
    d2h = counters["copy.d2h_bytes"]["by_span"]
    assert not {"decoder.pass", "decoder.final"} & set(d2h) and d2h["decoder.extract.stats"] > 0
