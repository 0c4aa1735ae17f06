"""The U-FISH network at its published widths (the ufish_c32 family: base
32, widths 32/64/128, ConvTranspose decoder) in the port, on the CPU.

The port's predictor (bf16 operands and layer outputs, f32 sums: K11's
plain version here) is held to the benchmark's plain float32 U-Net
(``benchmark/reference/ufish.py``, BatchNorm unfolded) on weights drawn
by ``benchmark/weights.py``, and two faults one step below the stated
precision read above the same bounds. The predictor's spans and counter,
its normalization without uploads, and the ``prod_rigid-cnn32`` cell's
files are checked too.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.generator import render_tile  # noqa: E402
from benchmark.reference.ufish import UFish, ufish_probability  # noqa: E402
from benchmark.tests import SMALL  # noqa: E402
from benchmark.ufish_faults import UFISH_FAULTS  # noqa: E402
from benchmark.weights import draw_ufish  # noqa: E402
from merfish3d_tpu_torch.models import ufish  # noqa: E402
from merfish3d_tpu_torch.utils import profiling  # noqa: E402

CELL = "prod_rigid-cnn32"
C32 = {"base_features": 32, "depths": [1, 2, 4], "up_mode": "convtranspose"}
SEED = 2**31 + 41

# bf16 keeps 8 significant bits, so each of the 13 convolutions rounds its
# output once by up to 2**-9 relative (the program's one formulation; the
# reference keeps float32). Carried through the chain and the sigmoid, that
# reads a mean probability gap of 0.87e-3 to 1.23e-3 and a largest of
# 3.8e-3 to 6.5e-3 (five weight seeds, both plane shapes below). The
# bounds sit 2.4x and 3.1x above those. Rounding every layer to fp8 (3
# mantissa bits: 16x coarser) reads a mean of 1.2e-2 or more and a largest
# of 5.1e-2 or more; an unflipped ConvTranspose kernel 5.8e-2 and 0.23.
MEAN_GAP, MAX_GAP = 3e-3, 0.02

# (crop of a rendered bit: bit, planes, y, x); 70x90 is reflect-padded to 128x128
PLANES = {"two_64x64": (3, slice(3, 5), slice(40, 104), slice(50, 114)),
          "one_70x90": (9, slice(6, 7), slice(100, 170), slice(60, 150))}


@pytest.fixture(scope="module")
def bits():
    _, _, config = harness.load_cell(CELL)
    return render_tile({**config, **SMALL}, SEED, 0, "cpu").bits[0].astype(np.float32)  # (16, 12, 192, 192)


@pytest.fixture(scope="module")
def variables():
    return draw_ufish(SEED, C32["base_features"], C32["depths"], C32["up_mode"])


def _planes(bits, name) -> torch.Tensor:
    b, z, y, x = PLANES[name]
    return torch.as_tensor(np.ascontiguousarray(bits[b, z, y, x]))


def _gaps(variables, planes) -> tuple[float, float]:
    predictor = ufish.UFishPredictor(params=variables, device="cpu")
    got = predictor.predict_planes(planes)
    want = ufish_probability(planes[None], UFish(variables, "cpu"))[0]
    d = (got - want).abs()
    return float(d.mean()), float(d.max())


@pytest.mark.parametrize("name", PLANES)
def test_the_c32_network_follows_the_plain_unet(bits, variables, name):
    net = ufish.UFishPredictor(params=variables, device="cpu").net
    assert (net.base_features, list(net.depths), net.up_mode) == tuple(C32.values())
    mean, peak = _gaps(variables, _planes(bits, name))
    assert mean <= MEAN_GAP and peak <= MAX_GAP, (mean, peak)


@pytest.mark.parametrize("name", PLANES)
@pytest.mark.parametrize("fault", sorted(UFISH_FAULTS))
def test_a_fault_reads_above_the_bounds(bits, variables, fault, name):
    with UFISH_FAULTS[fault]():
        mean, peak = _gaps(variables, _planes(bits, name))
    assert mean > MEAN_GAP and peak > MAX_GAP, (mean, peak)


class _Ops(TorchDispatchMode):
    """Every aten op dispatched, with the host clock of its call."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((time.time_ns(), func.name()))
        return func(*args, **(kwargs or {}))


# ops that make a tensor of host data or move one: an upload on the card
MOVES = ("aten::lift_fresh", "aten::lift_fresh_copy", "aten::_to_copy", "aten::copy_")


def test_spans_and_counter_a_batch_and_no_upload_in_normalization(bits, variables):
    planes = torch.as_tensor(np.ascontiguousarray(bits[0, :5, :64, :64]))
    predictor = ufish.UFishPredictor(params=variables, device="cpu")
    profiling.enable()
    profiling.reset()
    try:
        with _Ops() as seen:
            predictor.predict_planes(planes, batch_size=2)  # batches of 2, 2 and 1 + a zero plane
        snap, records = profiling.snapshot(), profiling.records()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert snap["spans"]["ufish.normalize"]["calls"] == snap["spans"]["ufish.net"]["calls"] == 3
    assert snap["counters"]["ufish.planes"]["total"] == 5
    assert "ufish.normalize" not in snap["counters"].get("copy.h2d_bytes", {"by_span": {}})["by_span"]
    windows = [(r.start_ns, r.end_ns) for r in records if r.name == "ufish.normalize"]
    inside = [op for t, op in seen.ops if any(s <= t <= e for s, e in windows)]
    assert "aten::sort" in inside and not [op for op in inside if op in MOVES], inside


def _old_percentile_normalize(planes):
    """The normalization as it stood with its positions and weights as
    tensors built on the host and uploaded every call."""
    s = torch.sort(planes.reshape(planes.shape[0], -1), dim=-1).values
    n = torch.tensor(float(s.shape[-1]), dtype=torch.float32)
    pos = torch.tensor([1.0, 99.8], dtype=torch.float32) / 100 * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    q = s[:, low.clamp(0, n - 1).long()] * lw + s[:, high.clamp(0, n - 1).long()] * hw
    lo, hi = q[:, 0, None, None], q[:, 1, None, None]
    return torch.clamp((planes - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


@pytest.mark.parametrize("shape", [(3, 96, 96), (2, 70, 90), (1, 1, 1), (2, 1, 2), (1, 333, 777)])
def test_normalization_is_bit_equal_to_the_uploading_form(shape):
    planes = (torch.rand(shape, generator=torch.Generator().manual_seed(7)) ** 4 * 60000).float()
    assert torch.equal(ufish.percentile_normalize(planes), _old_percentile_normalize(planes))


def test_the_cell_loads_and_names_base_32():
    entry, workload, config = harness.load_cell(CELL)
    _, nodecon, rigid = harness.load_cell("prod_rigid-nodecon")
    assert entry["chips"] == 1 and entry["config"] == "prod_rigid_ufish_c32"
    assert config["decode"]["predictor"] == "ufish_c32" and config["decode"]["predictor_weights"] == C32
    assert "bf16" in config["precision"] and config["precision"].startswith(rigid["precision"])
    # the rest of the tile is prod_rigid-nodecon's
    differ = ("source", "precision", "assumed", "decode")
    assert {k: v for k, v in config.items() if k not in differ} == {k: v for k, v in rigid.items() if k not in differ}
    assert {k: v for k, v in config["decode"].items() if not k.startswith("predictor")} == \
        {k: v for k, v in rigid["decode"].items() if k != "predictor"}
    assert workload["registration"] == nodecon["registration"] and workload["pool_tiles"] == nodecon["pool_tiles"]
    assert {k: v for k, v in workload["limits"].items() if k != "prob_l1"} == \
        {k: v for k, v in nodecon["limits"].items() if k != "prob_l1"}
    # nodecon's metrics, and the predictor's three
    end_to_end, per_layer = harness.cell_metrics(CELL)
    twin_end_to_end, twin_per_layer = harness.cell_metrics("prod_rigid-nodecon")
    assert {m["name"] for m in end_to_end} == {m["name"] for m in twin_end_to_end} == \
        {"tile_s", "f1", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in per_layer} == \
        {m["name"] for m in twin_per_layer} | {"predict_s", "predict_idle_pct", "ufish_roofline"}
    pipe = harness.Pipeline(workload, config, "cpu", seed=SEED)
    assert ufish.topology_from_flax(pipe.ufish_variables)["base_features"] == 32
    assert pipe.program_registration_options()["ufish_checkpoint"] == str(pipe.checkpoint)
