#!/usr/bin/env python3
"""Where the time of the port's fiducial registration and decode stage
goes, at production geometry on one GPU.

    python3 profile_decode.py

Run from the root of a checkout, on a machine with a CUDA device. It makes
the production tile as ``chip_smoke.py`` does (one (16, 1024, 1024) tile x
16 bits, 2400 spots, 8 fiducial rounds shifted by up to 2 px, seed 21).
First the fiducial registration of its 7 moving rounds runs twice under
``torch.profiler``: wall time, device busy share and device ops (the
second run is read; the first also uploads constants and plans
``torch.fft``). Then it runs the decode stage (normalization
optimization, 3 iterations, + final decode) three times in one process,
each on a freshly registered store:

1. unsectioned: the plain wall time (the first run also builds the
   kernels and warms the allocator);
2. sectioned: each section below is timed on the host clock, with
   ``torch.cuda.synchronize()`` at its entry and exit so device work is
   charged to the section that queued it;
3. profiled: ``torch.profiler`` over CPU and CUDA. The device busy share
   is the union of the device (kernel and copy) intervals over the wall.
   The profiler's own "Activity Buffer Request" row in the table is a
   host event and is not among them.

Prints the card's name and power limit, the times, and the profiler's
device ops by self device time.
"""

from __future__ import annotations

import collections
import sys
import time

import chip_smoke

# (owner, attribute, label); a label that starts with "- " runs inside the
# section above it. ``gaussian_lowpass`` is counted both inside seeding and
# in the optimization passes.
SECTIONS = (
    ("decoder.PixelDecoder", "_load_warped_bit_stack", "load stack (u16/u8 upload + product)"),
    ("decoder", "seed_stats_program", "seed_stats_program (incl. its lowpass)"),
    ("decoder", "gaussian_lowpass", "plain gaussian_lowpass (seeding + optimization)"),
    ("decoder", "decode_volume", "decode_volume (K3, thresholds, device-to-host)"),
    ("decoder", "gather_values", "optimization foreground gather"),
    ("decoder", "fused_decode_volume", "fused_decode_volume (K1+K2, device-to-host, gather)"),
    ("decoder.PixelDecoder", "_extract_barcodes", "extraction, total"),
    ("decoder.native", "label_components_sparse", "- label_components_sparse (C++)"),
    ("decoder", "component_stats_host", "- component_stats_host (numpy)"),
    ("decoder.PixelDecoder", "_iterative_normalization_vectors", "iterative vectors"),
    ("decoder.PixelDecoder", "_apply_filter_method", "blank-fraction filter"),
)


def _timed(fn, label, acc):
    import torch

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            acc[label] += time.perf_counter() - t0

    return wrapper


def sectioned_run(raw) -> tuple[dict, float, float]:
    from merfish3d_tpu_torch.pipeline import decoder

    acc: dict = collections.defaultdict(float)
    saved = []
    for owner_path, attr, label in SECTIONS:
        owner = decoder
        for part in owner_path.split(".")[1:]:
            owner = getattr(owner, part)
        fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, _timed(fn, label, acc))
    try:
        _, t_opt, t_final = chip_smoke.decode_stage(chip_smoke.registered_store(raw))
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return dict(acc), t_opt, t_final


def device_busy_seconds(events) -> float:
    """Union of the device-side event intervals (kernels and copies), in
    seconds."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy * 1e-6


def profile_registration(raw) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    log = chip_smoke.log
    reg = DataRegistration(convert_data(raw), device="cuda")
    for run in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reg._generate_registrations(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = device_busy_seconds(prof.events())
        log(f"registration run {run}, profiled: 7 moving rounds in {wall:.4f} s "
            f"({wall / 7:.4f} s a round); device busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import merfish3d_tpu_torch  # noqa: F401  (sets the full-f32 precision flags)

    log = chip_smoke.log
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    raw = chip_smoke.production_raw()
    log(f"generator {time.perf_counter() - t0:.3f} s")
    profile_registration(raw)

    _, t_opt, t_final = chip_smoke.decode_stage(chip_smoke.registered_store(raw))
    log(f"run 1, unsectioned: optimization {t_opt:.3f} s + final {t_final:.3f} s "
        f"= {t_opt + t_final:.3f} s")

    sections, t_opt, t_final = sectioned_run(raw)
    log(f"run 2, sectioned: optimization {t_opt:.3f} s + final {t_final:.3f} s "
        f"= {t_opt + t_final:.3f} s")
    for _, _, label in SECTIONS:
        log(f"  {label:58s} {sections.get(label, 0.0):.4f} s")
    top = sum(sec for label, sec in sections.items()
              if not label.startswith("- ") and "gaussian_lowpass" not in label)
    log(f"  sum of the top-level sections (lowpass is inside seeding and optimization) "
        f"{top:.4f} s")

    store = chip_smoke.registered_store(raw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, t_opt, t_final = chip_smoke.decode_stage(store)
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof.events())
    log(f"run 3, profiled: optimization {t_opt:.3f} s + final {t_final:.3f} s; wall {wall:.3f} s; "
        f"device busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
