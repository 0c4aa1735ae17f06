"""Faults in the U-FISH network that a U-FISH cell's check has to catch:
one precision step below the network's stated bf16 (``ufish_fp8``) and a
misplaced decoder tap (``ufish_unflipped_up``). Each is a context manager
that patches one attribute of the program and restores it, as
:mod:`.faults`' are.

Calibration readings with a fault planted, one JSON line each (the form
``calibrate.py`` prints):

    python3 benchmark/ufish_faults.py --workload prod_rigid-cnn32 --fault ufish_fp8 --seeds 1,2,3
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.faults import _patched  # noqa: E402

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def ufish_fp8():
    """Every convolution's output saturated to ±448 and rounded to
    float8_e4m3fn (3 mantissa bits, bf16's 7), then carried on in the
    network's own type."""
    from merfish3d_tpu_torch.models import ufish

    def make(inner):
        def fp8(self, x):
            y = inner(self, x)
            return y.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(y.dtype)
        return fp8
    return _patched(ufish._Conv, "forward", make)


def ufish_unflipped_up():
    """``params_from_flax`` without the ConvTranspose kernel flip: each
    decoder tap lands at the mirrored sub-position of its 2×2 output."""
    from merfish3d_tpu_torch.models import ufish

    def make(inner):
        def unflipped(variables):
            params = {k: {**v, "kernel": np.asarray(v["kernel"])[::-1, ::-1]} if k.startswith("ConvTranspose_") else v
                      for k, v in variables["params"].items()}
            return inner({**variables, "params": params})  # flipped back by the conversion's own flip
        return unflipped
    return _patched(ufish, "params_from_flax", make)


UFISH_FAULTS = {f.__name__: f for f in (ufish_fp8, ufish_unflipped_up)}


def main() -> int:
    from benchmark.calibrate import readings

    parser = argparse.ArgumentParser(description="Calibration readings of a U-FISH cell with a fault planted.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--fault", required=True, choices=sorted(UFISH_FAULTS))
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args()
    seeds = [int(v) for v in args.seeds.split(",") if v]
    with UFISH_FAULTS[args.fault]():
        for reading in readings(args.workload, seeds, []):
            print(json.dumps({"workload": args.workload, **reading, "kind": args.fault}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
