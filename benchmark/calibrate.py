"""Readings that the correctness limits are set from.

For each seed of ``--seeds``: the seed's first tile through the program
(after one warm-up tile) and through the plain reference, and the gaps
between them (the lower readings). For each seed of ``--control-seeds``:
the reference again in its control precision (:mod:`.reference.precision`)
in the program's place, and its gaps to the float32 reference (the upper
readings). With ``--fault <name>`` (:mod:`.faults`) the program seeds run
with that fault planted. One JSON line a reading on standard output, with
the program tile's F1 counts:

    python3 benchmark/calibrate.py --workload prod_rigid-decon --seeds 1,2 --control-seeds 1
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from contextlib import nullcontext  # noqa: E402

from benchmark.compare import capture  # noqa: E402
from benchmark.f1 import f1_counts  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402
from benchmark.generator import render_tile  # noqa: E402
from benchmark.harness import Pipeline, load_cell, require_cards  # noqa: E402
from benchmark.reference import precision  # noqa: E402


def readings(name: str, seeds, control_seeds, device: str = "cuda", config_override=None, fault=None):
    """Yield one dict a reading: kind (program or control), seed, gaps,
    and the seconds each side took."""
    import torch

    entry, workload, config = load_cell(name)
    if config_override:
        config = {**config, **config_override}
    if device == "cuda":
        require_cards(entry["chips"])
    warm = False
    for seed in sorted(set(seeds) | set(control_seeds)):
        pipe = Pipeline(workload, config, device, seed=seed)  # with the seed's own drawn weights, if any
        tile = render_tile(config, seed, 0, device)
        if seed in seeds:
            if not warm:
                pipe.run_tile(tile)
                warm = True
            t0 = time.perf_counter()
            with FAULTS[fault]() if fault else nullcontext():
                got = capture(*pipe.run_tile(tile))
            t1 = time.perf_counter()
            spacing = np.asarray(tile.voxel_size_zyx_um)
            yield {"kind": fault or "program", "seed": seed, "gaps": pipe.reference_gaps(tile, got),
                   "program_s": t1 - t0, "reference_s": time.perf_counter() - t1,
                   "f1_counts": f1_counts(got.table, tile.ground_truth, config["f1_match_radius_um"]),
                   "shifts_px": [[round(float(v), 4) for v in got.transforms[r][:3, 3] / spacing]
                                 for r in sorted(got.transforms)],
                   "injected_px": np.round(tile.round_shifts_px_zyx, 4).tolist()}
        if seed in control_seeds:
            t0 = time.perf_counter()
            with precision.control():
                store = pipe.reference_registration(tile)
                low = capture(store, pipe.reference_decode(store))
            t1 = time.perf_counter()
            yield {"kind": "control", "seed": seed, "gaps": pipe.reference_gaps(tile, low),
                   "control_s": t1 - t0, "reference_s": time.perf_counter() - t1}
        del tile
        if device == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", choices=sorted(FAULTS))
    args = parser.parse_args()
    parse = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    for reading in readings(args.workload, parse(args.seeds), parse(args.control_seeds), fault=args.fault):
        print(json.dumps({"workload": args.workload, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
