"""The benchmark's run: one cell, one seed.

Set-up renders the workload's pool of tiles from the seed
(:mod:`.generator`) and pushes one tile through the whole chain to build
and warm everything. The window then runs tiles back to back, cycling
through the pool, each
through the entry points users run, on a fresh store:
``convert_data`` → ``DataRegistration(...).register_all_tiles()`` →
``decode_pixels``, from host uint16 arrays to the filtered decoded table
and a device synchronize. It closes when ``--seconds`` have passed and the
tiles in flight have completed the pool (so every window holds each pool
tile equally often). With ``--trace 1`` the per-layer spans are wrapped
around the program's calls and ``torch.profiler`` records the window.

After the window a tile drawn from the seed is run through the plain
reference (:mod:`.reference`) and held to it (:mod:`.compare`). Both
sides take the same options: the workload file's ``registration`` and
``decode`` entries over those its configuration implies. A configuration
whose ``decode`` names ``predictor_weights`` scores spots with a U-FISH
network drawn from the seed (:mod:`.weights`): the program reads it from
the checkpoint file the run writes (its ``ufish_checkpoint`` option), the
reference is handed the same dict. The last line
of standard output is the result, as JSON; an end-to-end metric named
``<quantity>.<suffix>`` reports the quantity (``f1.deformed`` is ``f1``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "merfish3d_tpu")
PORT = "merfish3d_tpu_torch"


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json entry, workload file, configuration file) of a cell."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    return entry, workload, config


def cell_metrics(name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics this cell reports."""
    bench = load_json(ROOT / "BENCHMARK.json")

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    return [m for m in bench["end_to_end"] if here(m)], [m for m in bench["per_layer"] if here(m)]


def load_metric(name: str):
    """``metrics/<name>.py``, the per-layer metric's own module."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"this cell needs {chips} CUDA device(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Pipeline:
    """The program's entry points and a cell's options for them."""

    workload: dict
    config: dict
    device: str
    seed: int = 0
    ufish_variables: Optional[dict] = None  # the drawn U-FISH network, if the configuration asks for one
    checkpoint: Optional[Path] = None  # the file the run wrote it to for the program

    def __post_init__(self):
        self.convert = importlib.import_module(f"{PORT}.cli.simulation.convert_to_datastore")
        self.registration = importlib.import_module(f"{PORT}.pipeline.registration")
        self.pixeldecode = importlib.import_module(f"{PORT}.cli.simulation.pixeldecode")
        spec = self.config["decode"].get("predictor_weights")
        if spec is not None:
            from .weights import draw_ufish, write_checkpoint

            self.ufish_variables = draw_ufish(self.seed, spec["base_features"], spec["depths"], spec["up_mode"])
            folder = tempfile.mkdtemp(prefix="ufish-")  # under TMPDIR; removed with the pipeline or at exit
            weakref.finalize(self, shutil.rmtree, folder, True)
            self.checkpoint = write_checkpoint(self.ufish_variables, Path(folder) / "ufish.pkl")

    def registration_options(self) -> dict:
        """``DataRegistration``'s options, for the program and the
        reference alike."""
        c = self.config
        return dict(ufish_model=c["decode"]["predictor"], deformable_registration=c["deformable_registration"],
                    **self.workload["registration"])

    def program_registration_options(self) -> dict:
        """The shared options, and the drawn network's checkpoint file."""
        options = self.registration_options()
        if self.checkpoint is not None:
            options["ufish_checkpoint"] = str(self.checkpoint)
        return options

    def reference_registration_options(self) -> dict:
        """The shared options, and the drawn network itself."""
        options = self.registration_options()
        if self.ufish_variables is not None:
            options["ufish_variables"] = self.ufish_variables
        return options

    def decode_options(self) -> dict:
        """``decode_pixels``'s options, for the program and the reference
        alike."""
        d = self.config["decode"]
        options = dict(minimum_pixels=d["minimum_pixels"], magnitude_threshold=tuple(d["magnitude_threshold"]),
                       num_iterations=d["num_iterations"], target_misid_rate=d["target_misid_rate"],
                       estimate_chromatic_affines=self.config["estimate_chromatic_affines"],
                       lowpass_sigma=tuple(d["lowpass_sigma_zyx"]))
        return {**options, **self.workload.get("decode", {})}

    def run_tile(self, tile):
        """One tile through the program on a fresh store; returns (store,
        filtered table) once the device is idle."""
        import torch

        store = self.convert.convert_data(tile, device=self.device)
        self.registration.DataRegistration(store, device=self.device,
                                           **self.program_registration_options()).register_all_tiles()
        table = self.pixeldecode.decode_pixels(store, device=self.device, num_tiles=1, **self.decode_options())
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return store, table

    def reference_registration(self, tile):
        """The raw tile registered, and every readout bit deconvolved and
        scored, by the plain reference; returns its store."""
        from .reference.chain import convert_data
        from .reference.registration import DataRegistration

        store = convert_data(tile)
        DataRegistration(store, device=self.device, **self.reference_registration_options()).register_all_tiles()
        return store

    def reference_decode(self, store):
        """The plain reference's own decode of ``store``; returns the table."""
        from .reference.chain import decode_pixels

        return decode_pixels(store, device=self.device, **self.decode_options())

    def reference_gaps(self, tile, got) -> dict:
        """Hold a run's outputs ``got`` of ``tile`` to the reference
        (:mod:`.compare`)."""
        from .compare import capture, concat, decode_gaps, registration_gaps, shift_residual_px
        from .reference.chain import blank_fraction_filter, handoff_store, replay_decode

        t0 = time.perf_counter()
        options = self.registration_options()
        numbers = registration_gaps(got, capture(self.reference_registration(tile)), tile,
                                    decon=options["decon_readout"], flow=options["deformable_registration"],
                                    fid_decon=options.get("decon_fiducial", True))
        t1 = time.perf_counter()
        store = handoff_store(tile, got)
        passes, final = replay_decode(store, [concat(p) for p in got.passes], device=self.device,
                                      **self.decode_options())
        filtered = blank_fraction_filter(store, got.decoded, self.decode_options()["target_misid_rate"])
        numbers.update(decode_gaps(got, passes, final, filtered, capture(store).chromatic,
                                   chromatic=self.config["estimate_chromatic_affines"]))
        print(f"reference: registration {t1 - t0:.3f} s, decode {time.perf_counter() - t1:.3f} s; "
              f"round shifts within {shift_residual_px(got, tile):.4f} px of the injected ones",
              file=sys.stderr, flush=True)
        return numbers


@dataclass
class Window:
    """What the measured window produced."""

    seconds: float = 0.0
    outputs: list = field(default_factory=list)  # (pool index, TileOutput)
    tile_seconds: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[dict] = None


def run_window(pipe: Pipeline, pool: list, seconds: float, profiler=None) -> Window:
    import torch

    from .compare import capture
    from .trace import WINDOW

    cuda = torch.device(pipe.device).type == "cuda"
    win = Window()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if profiler is not None:
        profiler.start()
    with torch.profiler.record_function(WINDOW):
        start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            store, table = pipe.run_tile(pool[i % len(pool)])
            win.outputs.append((i % len(pool), capture(store, table)))
            del store
            i += 1
            now = time.perf_counter()
            win.tile_seconds.append(now - t0)
            if now - start >= seconds and i % len(pool) == 0:
                break
        win.seconds = time.perf_counter() - start
    if profiler is not None:
        profiler.stop()
    if cuda:
        win.peak_bytes = int(torch.cuda.max_memory_allocated())
    return win


def judge(pipe: Pipeline, pool: list, win: Window, seed: int, limits: dict) -> tuple[dict, bool]:
    """Hold one window tile, drawn from the seed, to the reference.
    Returns ({number: {value, limit}}, every number within its limit)."""
    pick = int(np.random.default_rng(seed % 2**64).integers(len(win.outputs)))
    index, got = win.outputs[pick]
    numbers = pipe.reference_gaps(pool[index], got)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(v <= limits[k] for k, v in numbers.items())


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", config_override: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``config_override`` and ``device="cpu"`` are for the tests, which
    drive the harness at a small size without a card."""
    import torch

    from .f1 import f1_counts, f1_score
    from .generator import render_tile

    entry, workload, config = load_cell(name)
    if config_override:
        config = {**config, **config_override}
    if device == "cuda":
        require_cards(entry["chips"])
    end_to_end, per_layer = cell_metrics(name)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731

    pipe = Pipeline(workload, config, device, seed=seed)
    t_import = time.perf_counter()
    pool = [render_tile(config, seed, k, device) for k in range(workload["pool_tiles"])]
    t_render = time.perf_counter()
    pipe.run_tile(pool[-1])
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    log(f"setup {setup_s:.3f} s: imports {t_import - t_start:.3f}, render {t_render - t_import:.3f}, "
        f"warm-up tile {t_warm - t_render:.3f}")

    spans = modules = profiler = None
    if trace:
        from .spans import Spans

        spans = Spans(device)
        modules = {m["name"]: load_metric(m["name"]) for m in per_layer}
        for module in modules.values():
            module.install(spans)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    try:
        win = run_window(pipe, pool, seconds, profiler)
    finally:
        if spans is not None:
            spans.restore()
    n = len(win.outputs)
    log(f"window {win.seconds:.3f} s, {n} tiles ({', '.join(f'{t:.3f}' for t in win.tile_seconds)} s), "
        f"peak {win.peak_bytes} B")

    metrics = {}
    breakdown = None
    if trace:
        from .trace import reduce_trace

        win.trace = reduce_trace(profiler) if device == "cuda" else None
        context = {"spans": spans, "tiles": n, "trace": win.trace, "window_s": win.seconds}
        for m in per_layer:
            value = modules[m["name"]].read(context)
            if value is None:
                log(f"metric {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if win.trace is not None:
            breakdown = {"device_ops": win.trace["device_ops"], "idle_gaps": win.trace["idle_gaps"]}
    else:
        tp = n_dec = n_gt = 0
        for index, out in win.outputs:
            counts = f1_counts(out.table, pool[index].ground_truth, config["f1_match_radius_um"])
            tp, n_dec, n_gt = tp + counts[0], n_dec + counts[1], n_gt + counts[2]
        values = {"tile_s": win.seconds / n, "f1": f1_score(tp, n_dec, n_gt),
                  "peak_mem_gib": win.peak_bytes / 2**30, "setup_s": setup_s}
        log(f"f1: tp {tp}, decoded {n_dec}, ground truth {n_gt}")
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]} for m in end_to_end}

    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, ok = judge(pipe, pool, win, seed, workload["limits"])
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded modules it must not: {', '.join(bad)}")
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": entry["chips"], "memory_peak_bytes": win.peak_bytes}
    if win.trace is not None:
        dev["busy_s"] = win.trace["busy_s"]
        dev["window_s"] = win.trace["window_s"]
    result = {"correct": ok, "attempted": n, "failed": 0 if ok else 1, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell and print its result line.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0
