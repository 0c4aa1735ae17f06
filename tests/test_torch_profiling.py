"""The port's tracing registry (merfish3d_tpu_torch.utils.profiling), on CPU.

Off, it records nothing and labels nothing. On, over a small tile's chain
``convert_data`` → ``DataRegistration`` → ``decode_pixels`` (and a flow
estimate and a paired RLGC solve), it nests spans, links parents, gives
self times and one run id a store, puts its spans on the profiler's clock
within 1 ms, counts the bytes of each host↔device crossing exactly as
the arrays' sizes say, and counts no kernel launch on the CPU path.
"""

import time

import numpy as np
import pytest
import scipy.ndimage
import torch
from torch.profiler import ProfilerActivity, profile

from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import generate_raw_experiment
from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels
from merfish3d_tpu_torch.ops import flow, rlgc
from merfish3d_tpu_torch.ops.decode import decode_volume
from merfish3d_tpu_torch.pipeline.registration import DataRegistration
from merfish3d_tpu_torch.utils import profiling

CLOCK_TOL_NS = 1_000_000
ENTRY_SPANS = ("datastore.convert", "registration.tile", "decoder.decode_pixels")


@pytest.fixture
def tracing():
    profiling.enable()
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _span_events(prof) -> list:
    """(name, start ns, end ns) of the profiler's host ``span:`` ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("span:") and str(e.device_type()).split(".")[-1] == "CPU":
            out.append((e.name()[len("span:"):], e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _raw():
    return generate_raw_experiment(shape=(12, 96, 96), seed=11, distribution="cells")


def _chain(raw):
    store = convert_data(raw, device="cpu")
    DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=False,
                     ufish_model="dog").register_all_tiles()
    decode_pixels(store, device="cpu", minimum_pixels=4, num_tiles=1, num_iterations=2)
    return store


@pytest.fixture(scope="module")
def traced_chain():
    """The small chain once, tracing on, under the profiler (CPU events):
    (raw, store, records, snapshot, span events)."""
    raw = _raw()
    profiling.enable()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            store = _chain(raw)
        records, snap = profiling.records(), profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    return raw, store, records, snap, _span_events(prof)


def test_off_records_nothing():
    assert not profiling.enabled()
    vol = np.random.default_rng(0).random((16, 3, 8, 8)).astype(np.float32)
    cb = np.eye(16, dtype=np.float32)[:6] + np.eye(16, dtype=np.float32)[6:12]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.off"):
            decode_volume(vol, cb, np.zeros(16), np.ones(16), distance_threshold=0.5, device="cpu")
            profiling.count("test.counter")
            profiling.read_scalar(torch.ones(()))
            profiling.to_device(np.zeros(4), "cpu")
    assert profiling.records() == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert _span_events(prof) == []


def test_nesting_parents_and_self_time(tracing):
    with tracing.span("outer.a", run=7):
        time.sleep(0.02)
        with tracing.span("inner.b"):
            time.sleep(0.03)
            tracing.count("test.n", 2)
        with tracing.span("inner.b"):
            tracing.to_device(np.zeros(5, np.float32), "cpu")
    with tracing.span("outer.c"):
        tracing.count("test.n")
    recs = tracing.records()
    assert [r.name for r in recs] == ["outer.a", "inner.b", "inner.b", "outer.c"]
    assert [r.parent for r in recs] == [None, 0, 0, None]
    assert [r.run for r in recs] == [7, 7, 7, None]
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[0].start_ns <= recs[1].start_ns and recs[2].end_ns <= recs[0].end_ns
    snap = tracing.snapshot()
    a, b = snap["spans"]["outer.a"], snap["spans"]["inner.b"]
    assert b["calls"] == 2 and a["calls"] == 1
    assert a["self_seconds"] == pytest.approx(a["seconds"] - b["seconds"], abs=1e-9)
    assert 0.015 <= a["self_seconds"] < a["seconds"] and b["self_seconds"] >= 0.025
    assert snap["counters"]["test.n"] == {"total": 3, "by_span": {"inner.b": 2, "outer.c": 1}}
    assert snap["counters"]["copy.h2d_bytes"] == {"total": 20, "by_span": {"inner.b": 20}}


def test_set_run_reaches_spans_recorded_inside(tracing):
    with tracing.span("entry.x"):
        with tracing.span("child.y"):
            pass
        tracing.set_run(3)
        with tracing.span("child.z"):
            pass
    assert [r.run for r in tracing.records()] == [3, 3, 3]


def test_reset_keeps_open_spans(tracing):
    with tracing.span("outer.a"):
        with tracing.span("inner.b"):
            tracing.count("test.n")
        tracing.reset()
        with tracing.span("inner.c"):
            pass
    recs = tracing.records()
    assert [(r.name, r.parent) for r in recs] == [("outer.a", None), ("inner.c", 0)]
    assert tracing.snapshot()["counters"] == {}


def test_clock_matches_profiler():
    """A span's registry times and its ``span:`` event's agree within 1 ms
    at both ends."""
    profiling.enable()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):
                with profiling.span(f"clock.s{i}"):
                    torch.ones(1000).sum()
                    time.sleep(0.005)
        recs = profiling.records()
    finally:
        profiling.enable(False)
        profiling.reset()
    events = {name: (s, e) for name, s, e in _span_events(prof)}
    assert len(events) == len(recs) == 5
    for r in recs:
        s, e = events[r.name]
        assert abs(s - r.start_ns) <= CLOCK_TOL_NS and abs(e - r.end_ns) <= CLOCK_TOL_NS


def test_chain_spans_dotted_labelled_and_on_the_clock(traced_chain):
    _, _, records, snap, events = traced_chain
    names = {r.name for r in records}
    assert set(ENTRY_SPANS) <= names
    assert {"registration.fiducial", "registration.phase_corr", "registration.bits", "registration.predict",
            "registration.download", "decoder.seed", "decoder.load", "decoder.warp", "decoder.pass",
            "decoder.final", "decoder.vectors", "decoder.filter", "decoder.extract", "decoder.extract.label",
            "decoder.extract.stats", "decoder.extract.table", "datastore.clip", "datastore.psf"} <= names
    assert all("." in n for n in names)
    assert sorted(n for n, _, _ in events) == sorted(r.name for r in records)
    by_name: dict = {}
    for name, s, e in events:
        by_name.setdefault(name, []).append((s, e))
    for r in records:
        assert any(abs(s - r.start_ns) <= CLOCK_TOL_NS and abs(e - r.end_ns) <= CLOCK_TOL_NS
                   for s, e in by_name[r.name])
    assert snap["spans"]["decoder.pass"]["calls"] == 2 and snap["spans"]["decoder.final"]["calls"] == 1


def test_chain_shares_one_run_id(traced_chain):
    _, store, records, _, _ = traced_chain
    assert {r.run for r in records} == {store.run_id}
    entries = [r for r in records if r.name in ENTRY_SPANS]
    assert [r.name for r in entries] == list(ENTRY_SPANS) and all(r.parent is None for r in entries)
    assert all(r.parent is not None for r in records if r.name not in ENTRY_SPANS)


def test_chain_bytes_equal_the_arrays(traced_chain):
    raw, store, _, snap, _ = traced_chain
    h2d = snap["counters"]["copy.h2d_bytes"]["by_span"]
    d2h = snap["counters"]["copy.d2h_bytes"]["by_span"]
    bits, rounds = raw.bits.shape[1], raw.fiducial.shape[1]
    voxels = int(np.prod(raw.bits.shape[2:]))
    du, pu = store.registered_stack(0)
    # the readout bits go up as u16, and come back as u16 decon and u8 probability
    assert h2d["registration.bits"] == bits * voxels * 2
    assert d2h["registration.download"] == du.nbytes + pu.nbytes == bits * voxels * 3
    # the decoder's stack upload is the two forms the store keeps
    assert h2d["decoder.load"] == du.nbytes + pu.nbytes
    # the reference fiducial comes back as int32, the warped rounds as u16
    assert d2h["registration.fiducial"] == voxels * 4 + (rounds - 1) * voxels * 2
    reads = snap["counters"]["copy.reads"]
    assert reads["total"] == sum(reads["by_span"].values()) > 0


def test_no_launch_counted_on_cpu(traced_chain):
    _, _, _, snap, _ = traced_chain
    assert not [c for c in snap["counters"] if c.startswith("launch.")]


def test_flow_sweeps_and_reads(tracing):
    rng = np.random.default_rng(3)
    ref = np.zeros((16, 64, 64), np.float32)
    for z, y, x in zip(rng.integers(2, 14, 60), rng.integers(4, 60, 60), rng.integers(4, 60, 60)):
        ref[z, y, x] = rng.uniform(500, 1000)
    ref = scipy.ndimage.gaussian_filter(ref, (1.0, 1.5, 1.5)) + 1.0
    moving = scipy.ndimage.shift(ref, (0.0, 0.6, -1.2), order=1, mode="nearest")
    cfg = flow.SofimaRegistrationConfig(patch_size_zyx=(8, 24, 24), stride_zyx=(4, 12, 12))
    _, meta = flow.estimate_sofima_flow_field_xyz_px(ref, moving, cfg, device="cpu")
    assert meta["valid_flow_vectors"] > 0
    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    passes = spans["flow.xcorr"]["calls"]
    assert spans["flow.estimate"]["calls"] == 1 and passes == cfg.residual_iterations
    assert spans["flow.relax"]["calls"] == passes and spans["flow.warp"]["calls"] == passes - 1
    sweeps = counters["flow.sweeps"]["by_span"]["flow.relax"]
    assert 1 <= sweeps <= passes * cfg.relax_iterations
    # a scalar read each sweep and the relaxed field's download, three lattice downloads a pass
    assert counters["copy.reads"]["by_span"] == {"flow.relax": sweeps + passes, "flow.xcorr": 3 * passes}


def test_rlgc_reads_one_record_a_step(tracing):
    rng = np.random.default_rng(1)
    obs = rng.poisson(20.0, (3, 12, 40, 40)).astype(np.float32)
    psf = np.ones((5, 5, 5), np.float32) / 125.0
    _, iters = rlgc.rlgc_batch(obs, psf, max_iters=3, out="host", device="cpu", return_iters=True)
    snap = tracing.snapshot()
    steps = snap["spans"]["rlgc.step"]["calls"]
    assert snap["spans"]["rlgc.solve"]["calls"] == 1 and steps >= max(iters)
    assert snap["spans"]["rlgc.read"]["calls"] == steps
    assert snap["counters"]["copy.reads"]["by_span"] == {"rlgc.read": steps, "rlgc.solve": 1}
    # the stack goes up once, and the result comes back once
    assert snap["counters"]["copy.d2h_bytes"]["by_span"]["rlgc.solve"] == obs.nbytes
    assert snap["counters"]["copy.h2d_bytes"]["by_span"]["rlgc.solve"] >= obs.nbytes
