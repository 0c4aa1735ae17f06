"""The U-FISH cell's benchmark parts: the network's least work
(:mod:`benchmark.ufish_work`), the device wall under a span
(:mod:`benchmark.device_spans`), the three predictor metrics, and a run
of ``prod_rigid-cnn32`` on the CPU at a small size."""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import device_spans, harness, span_idle, trace
from benchmark.reference.ufish import UFish
from benchmark.spans import Spans
from benchmark.tests import TINY
from benchmark.tests.test_bench_program_metrics import _Prof
from benchmark.ufish_work import least_seconds, network_ops
from benchmark.weights import draw_ufish
from merfish3d_tpu_torch.utils import profiling

C32 = {"base_features": 32, "depths": [1, 2, 4], "up_mode": "convtranspose"}
METRICS = ("predict_s", "predict_idle_pct", "ufish_roofline")


@pytest.fixture
def registry():
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def test_the_c32_network_at_a_production_plane():
    ops = network_ops(C32, 1024, 1024)
    assert len(ops) == 13 and all(op[1] > 0 for op in ops)  # the convolutions, no layout move
    assert sum(op[1] for op in ops) == pytest.approx(202.534551552e9)  # 51.8 TFLOP a tile of 256 planes
    # 0.350 ms of convolutions a plane, the weights (0.93 MB) once a call
    assert least_seconds(C32, 8, 1024, 1024) / 8 == pytest.approx(0.350e-3, rel=1e-3)


def test_flops_are_the_plain_unets():
    """The convolutions' flops equal what torch counts of the plain U-Net's
    convolutions on the same plane."""
    spec = {**C32, "base_features": 4}
    net = UFish(draw_ufish(5, 4, spec["depths"], spec["up_mode"]), "cpu")
    with FlopCounterMode(display=False) as counter:
        net.forward(torch.rand(2, 1, 64, 96))
    assert counter.get_total_flops() == pytest.approx(2 * sum(op[1] for op in network_ops(spec, 64, 96)))


@pytest.mark.parametrize("spec, width", [(C32, 1022), ({**C32, "up_mode": "resize"}, 1024)])
def test_what_it_does_not_count_is_refused(spec, width):
    with pytest.raises(ValueError):
        network_ops(spec, 1024, width)


# (name, is_device, start ns, end ns), a window of 0..100 ns
EVENTS = [
    ("span:window", False, 0, 100),
    ("span:ufish.net", False, 0, 5),  # the host queues and closes
    ("span:ufish.net", True, 10, 40),  # the device runs it
    ("span:ufish.net", False, 40, 45),
    ("span:ufish.net", True, 35, 60),
    ("span:ufish.net", True, 90, 130),
    ("span:ufish.normalize", True, -20, -10),
    ("kernel_a", True, 10, 20),
]


def test_device_spans_on_a_synthetic_trace():
    # ufish.net on the device: the union of 10..40, 35..60 and 90..100 (clipped)
    assert device_spans.device_spans(EVENTS) == {"ufish.net": [pytest.approx(60e-9), 3]}


@pytest.mark.parametrize("first", ["device_spans", "span_idle"])
def test_reduce_trace_gains_both_keys_in_either_order(monkeypatch, first):
    monkeypatch.setattr(trace, "reduce_trace", trace.reduce_trace)
    prof = _Prof(EVENTS)
    before = trace.reduce_trace(prof)
    order = [device_spans, span_idle] if first == "device_spans" else [span_idle, device_spans]
    for module in order * 2:  # each once a process
        module.install()
    after = trace.reduce_trace(prof)
    assert {k: v for k, v in after.items() if k not in ("span_idle", "device_spans")} == before
    assert after["device_spans"] == device_spans.device_spans(EVENTS)
    assert after["span_idle"] == span_idle.span_idle(EVENTS)
    assert device_spans.wall_s({"trace": after}, "ufish.net") == pytest.approx(60e-9)
    assert device_spans.wall_s({"trace": after}, "ufish.normalize") is None
    assert device_spans.wall_s({"trace": None}, "ufish.net") is None


def test_the_metrics_read_the_predictor(registry):
    from merfish3d_tpu_torch.models.ufish import UFishNet, UFishPredictor

    forward = UFishNet.forward
    spans = Spans("cpu")
    modules = {name: harness.load_metric(name) for name in METRICS}
    for module in modules.values():
        module.install(spans)
    try:
        assert registry.enabled()
        predictor = UFishPredictor(params=draw_ufish(5, 4, C32["depths"], "convtranspose"), device="cpu")
        predictor.forward(torch.rand(2, 3, 64, 64), batch_size=4)  # 6 planes: batches of 4 and 2 + 2 zero planes
        run = {"spans": spans, "tiles": 2, "trace": None}
        read = {name: module.read(run) for name, module in modules.items()}
        traced = modules["ufish_roofline"].read({**run, "trace": {"device_spans": {"ufish.net": [0.5, 2]}}})
    finally:
        spans.restore()
    assert not registry.enabled() and UFishNet.forward is forward
    assert read["predict_s"] == pytest.approx(spans.get("predict").total() / 2)
    # no device trace on the CPU
    assert read["predict_idle_pct"] is None and read["ufish_roofline"] is None
    calls = spans.get("ufish_calls").calls
    assert [shape for _, _, (_, shape) in calls] == [(4, 64, 64), (4, 64, 64)]
    assert all(spec == {**C32, "base_features": 4} for _, _, (spec, _) in calls)
    least = 2 * least_seconds({**C32, "base_features": 4}, 4, 64, 64) * 6 / 8  # two calls, 6 real planes of 8
    assert traced == pytest.approx(100 * least / 0.5)


def test_the_roofline_reads_nothing_without_the_counter(registry):
    """A program without ``ufish.planes`` (an older commit) reads None."""
    spans = Spans("cpu")
    spans.get("ufish_calls").calls.append((0.0, 0.0, (C32, (8, 1024, 1024))))
    run = {"spans": spans, "tiles": 1, "trace": {"device_spans": {"ufish.net": [1.0, 1]}}}
    assert harness.load_metric("ufish_roofline").read(run) is None


def test_the_cell_runs_the_cnn_on_the_cpu():
    """The cell through the harness at a small size, traced: every metric
    that needs no device trace reads, and the bf16 program's maps sit within the cell's
    ``prob_l1`` limit of the float32 reference's."""
    result = harness.run_cell("prod_rigid-cnn32", 2**33 + 5, 0.1, True, t_start=time.perf_counter(),
                              device="cpu", config_override=TINY)
    _, per_layer = harness.cell_metrics("prod_rigid-cnn32")
    device_traced = {"device_idle_pct", "predict_idle_pct", "ufish_roofline"}  # no device trace on the CPU
    assert "predict_s" in result["metrics"]
    assert set(result["metrics"]) == {m["name"] for m in per_layer} - device_traced
    assert result["correct"] is True, result["checks"]

