"""The per-layer metrics that read the program's own tracing registry, and
``span_idle``, the idle device time under each host span of a trace."""

import pytest

from benchmark import harness, program_counters, span_idle, trace
from benchmark.spans import Spans
from merfish3d_tpu_torch.utils import profiling

COUNTER_METRICS = ("d2h_gib_per_tile", "h2d_gib_per_tile", "host_reads_per_tile", "launches_per_tile")
NEW_METRICS = (*COUNTER_METRICS, "flow_sweeps_per_round", "rlgc_idle_pct", "flow_idle_pct")

# (name, is_device, start ns, end ns), a window of 0..100 ns
EVENTS = [
    ("span:window", False, 0, 100),
    ("span:rlgc.solve", False, 0, 30),
    ("span:rlgc.solve", False, 25, 40),
    ("span:decoder.extract", False, 55, 120),
    ("span:store", False, -10, -5),
    ("span:rlgc.solve", True, 0, 100),  # the label on the device timeline: not work
    ("kernel_a", True, 10, 20),
    ("Memcpy DtoH", True, 50, 60),
]


class _Event:
    def __init__(self, name, device, start, end):
        self._name, self._device, self._start, self._end = name, device, start, end

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _self: [_Event(*e) for e in events]})()


@pytest.fixture
def registry():
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def test_span_idle_on_a_synthetic_trace():
    got = span_idle.span_idle(EVENTS)
    assert set(got) == {"rlgc.solve", "decoder.extract"}
    # rlgc.solve: the union 0..40, busy 10..20
    assert got["rlgc.solve"] == pytest.approx([40e-9, 30e-9, 2])
    # decoder.extract: clipped to 55..100, busy 55..60
    assert got["decoder.extract"] == pytest.approx([45e-9, 40e-9, 1])


def test_reduce_trace_gains_span_idle_and_keeps_its_keys(monkeypatch):
    monkeypatch.setattr(trace, "reduce_trace", trace.reduce_trace)
    prof = _Prof(EVENTS)
    before = trace.reduce_trace(prof)
    assert before["busy_s"] == pytest.approx(20e-9) and before["window_s"] == pytest.approx(100e-9)
    assert [name for name, _ in before["device_ops"]] == ["kernel_a", "Memcpy DtoH"]
    span_idle.install()
    span_idle.install()  # once a process
    after = trace.reduce_trace(prof)
    assert {k: v for k, v in after.items() if k != "span_idle"} == before
    assert after["span_idle"] == span_idle.span_idle(EVENTS)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_install_traces_the_window_only(registry, monkeypatch, name):
    monkeypatch.setattr(trace, "reduce_trace", trace.reduce_trace)
    spans = Spans("cpu")
    harness.load_metric(name).install(spans)
    assert registry.enabled()
    spans.restore()
    assert not registry.enabled()


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_counters_read_zero_not_nothing(registry, name):
    assert harness.load_metric(name).read({"tiles": 4, "trace": None}) == 0.0


def test_counters_per_tile(registry):
    registry.enable()
    with registry.span("decoder.load"):
        registry.count("copy.h2d_bytes", 3 * 2**30)
        registry.count("copy.d2h_bytes", 2**29)
        registry.count("copy.reads", 6)
        registry.count("launch.decode_chunk_f32", 5)
        registry.count("launch.dft_leading.z", 7)
    run = {"tiles": 2, "trace": None}
    read = {name: harness.load_metric(name).read(run) for name in COUNTER_METRICS}
    assert read == {"d2h_gib_per_tile": 0.25, "h2d_gib_per_tile": 1.5, "host_reads_per_tile": 3.0,
                    "launches_per_tile": 6.0}


def test_sweeps_per_round(registry):
    module = harness.load_metric("flow_sweeps_per_round")
    assert module.read({"tiles": 1, "trace": None}) is None  # no flow estimate ran
    registry.enable()
    for sweeps in (10, 20):
        with registry.span("flow.estimate"):
            with registry.span("flow.relax"):
                registry.count("flow.sweeps", sweeps)
    assert module.read({"tiles": 1, "trace": None}) == 15.0


@pytest.mark.parametrize("name,span", [("rlgc_idle_pct", "rlgc.solve"), ("flow_idle_pct", "flow.estimate")])
def test_idle_share_of_a_span(name, span):
    module = harness.load_metric(name)
    assert module.read({"trace": {"span_idle": {span: [2.0, 0.5, 3]}}}) == 25.0
    assert module.read({"trace": {"span_idle": {}}}) is None
    assert module.read({"trace": {"busy_s": 1.0, "window_s": 2.0}}) is None  # a trace without span_idle
    assert module.read({"trace": None}) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_program_without_the_registry_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(program_counters, "registry", lambda: None)
    monkeypatch.setattr(trace, "reduce_trace", trace.reduce_trace)
    spans = Spans("cpu")
    module = harness.load_metric(name)
    module.install(spans)
    assert spans._restore == []
    assert module.read({"tiles": 1, "trace": {"busy_s": 0.0, "window_s": 1.0}}) is None
