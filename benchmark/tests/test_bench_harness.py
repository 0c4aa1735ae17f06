import json
import re
import time

import pytest

from benchmark import harness
from benchmark.generator import render_tile
from benchmark.spans import Spans
from benchmark.tests import SMALL

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {"tile_s", "f1", "f1.deformed", "peak_mem_gib", "setup_s"}
    assert all(m["moves"] == "tile_s" for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_loads_by_name(cell):
    entry, workload, config = harness.load_cell(cell)
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"]
    assert set(config["tile_shape_zyx"]) and config["n_tiles"] == 1
    end_to_end, per_layer = harness.cell_metrics(cell)
    assert {m["name"].split(".")[0] for m in end_to_end} == {"tile_s", "f1", "peak_mem_gib", "setup_s"}
    assert len(end_to_end) == 4
    for m in per_layer:
        module = harness.load_metric(m["name"])
        assert callable(module.install) and callable(module.read)
    numbers = {"shift_px", "prob_l1", "table_miss", "table_values", "gene_swaps"}
    if workload["registration"]["decon_readout"]:
        numbers.add("decon_l2")
    if workload["registration"].get("decon_fiducial", True):
        numbers.add("fid_decon_l2")
    if config["deformable_registration"]:
        numbers |= {"flow_px", "flow_valid"}
    if config["estimate_chromatic_affines"]:
        numbers.add("affine")
    assert set(workload["limits"]) == numbers


def test_no_card_fails_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_missing_attribute_reads_nothing(capsys):
    spans = Spans("cpu")
    span = spans.wrap("gone", "benchmark.harness", "no_such_function")
    assert not span.installed and span.calls == []
    assert "benchmark.harness.no_such_function is missing" in capsys.readouterr().err
    module = harness.load_metric("decode_s")
    assert module.read({"spans": spans, "tiles": 1, "trace": None}) is None


def test_span_records_calls_and_restores():
    spans = Spans("cpu")
    inner = harness.forbidden_modules
    spans.wrap("scan", "benchmark.harness", "forbidden_modules")
    assert harness.forbidden_modules() == inner()
    assert len(spans.get("scan").calls) == 1
    spans.restore()
    assert harness.forbidden_modules is inner


@pytest.mark.parametrize("cell", CELLS)
def test_both_sides_take_the_same_options(cell):
    """The workload's options reach the program and the reference by the
    same names; the reference accepts each cell's."""
    import inspect

    from benchmark.reference.registration import DataRegistration as Reference
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration as Program

    from benchmark.reference.chain import decode_pixels as reference_decode
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels as program_decode

    _, workload, config = harness.load_cell(cell)
    pipe = harness.Pipeline(workload, config, "cpu")
    for options, sides in ((pipe.registration_options(), (Program, Reference)),
                           (pipe.program_registration_options(), (Program,)),
                           (pipe.reference_registration_options(), (Reference,)),
                           (pipe.decode_options(), (program_decode, reference_decode))):
        for side in sides:
            assert set(options) <= set(inspect.signature(side).parameters)
    override = harness.Pipeline({**workload, "decode": {"estimate_chromatic_affines": True}}, config, "cpu")
    assert override.decode_options()["estimate_chromatic_affines"] is True


@pytest.mark.parametrize("option", [
    {"ufish_model": "simfish"},  # a U-FISH network with no weights to score with
    {"decon_fiducial": True, "crop_yx_decon": 64},  # a lateral-tiled single-volume solve
], ids=["cnn_without_weights", "lateral_tiled_solve"])
def test_the_reference_refuses_what_it_has_no_plain_version_of(option):
    from benchmark.reference.chain import convert_data
    from benchmark.reference.registration import DataRegistration

    _, workload, config = harness.load_cell("prod_rigid-nodecon")
    tile = render_tile({**config, **SMALL}, 3, 0, "cpu")
    options = {**harness.Pipeline(workload, config, "cpu").registration_options(), **option}
    with pytest.raises(NotImplementedError):
        DataRegistration(convert_data(tile), device="cpu", **options).register_all_tiles()


def test_swapped_gene_reads_two_and_a_moved_row_none():
    from benchmark.compare import table_gaps

    rows = {"gene_id": ["a", "b", "c"], "z": [1.0, 5.0, 9.0], "y": [2.0, 20.0, 40.0], "x": [3.0, 30.0, 60.0],
            "bit01_mean_intensity": [1.0, 2.0, 3.0]}
    swapped = {**rows, "gene_id": ["a", "c", "c"]}
    moved = {**rows, "y": [2.0, 23.0, 40.0]}
    assert table_gaps(rows, rows)[::2] == (0.0, 0)
    assert table_gaps(rows, swapped)[2] == 2
    assert table_gaps(rows, moved)[2] == 0 and table_gaps(rows, moved)[0] == 2 / 6


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    result = harness.run_cell("prod_rigid-nodecon", 2**31 + 3, 0.1, trace, t_start=time.perf_counter(),
                              device="cpu", config_override=SMALL)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert ("breakdown" in keys) is False  # no device trace on the CPU
    assert result["correct"] is True and result["attempted"] == 4 and result["failed"] == 0
    _, per_layer = harness.cell_metrics("prod_rigid-nodecon")
    expected = ({m["name"] for m in per_layer} - {"device_idle_pct"} if trace
                else {"tile_s", "f1", "peak_mem_gib", "setup_s"})
    assert set(result["metrics"]) == expected
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    json.dumps(result)


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    result = harness.run_cell("prod_rigid-nodecon", 2**31 + 3, 1.0, False, t_start=time.perf_counter())
    assert result["correct"] and result["device"]["platform"] == "gpu"
