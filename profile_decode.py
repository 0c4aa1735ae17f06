#!/usr/bin/env python3
"""Where the time of the port's fiducial registration, RLGC deconvolution
and decode stage goes, at production geometry on one GPU.

    python3 profile_decode.py

Run from the root of a checkout, on a machine with a CUDA device. It makes
the production tile as ``chip_smoke.py`` does (one (16, 1024, 1024) tile x
16 bits, 2400 spots, 8 fiducial rounds shifted by up to 2 px, seed 21).
First the fiducial registration of its 7 moving rounds runs twice under
``torch.profiler``: wall time, device busy share and device ops (the
second run is read; the first also uploads constants and plans
``torch.fft``). Then one readout batch — the 8 bits that share PSF 1,
padded to (32, 1152, 1152) — is deconvolved by ``rlgc_batch`` (paired
solves, 10 iterations, the production setting) under the profiler, after
a short warm-up solve: device time by kernel (K10's two passes, K9's
three, K4, K5, the DFT kernels of the OTF, copies, the other elementwise
ops), K9's and K10's shares of the device time and of the wall, the
device busy share and its complement (the host's share),
device-to-host copies per volume-iteration, and the split sampler's own
time (CUDA events). Then it runs the decode stage (normalization
optimization, 3 iterations, + final decode) three times in one process,
each on a freshly registered store:

1. unsectioned: the plain wall time (the first run also builds the
   kernels and warms the allocator);
2. sectioned: the port's own ``decoder.*`` spans
   (:mod:`merfish3d_tpu_torch.utils.profiling`, tracing on for this run),
   each with its calls, seconds and self seconds, and the bytes and reads
   that crossed between host and device under it. Spans time the host and
   never synchronize, so device work queued in one section may be waited
   for in a later one;
3. profiled: ``torch.profiler`` over CPU and CUDA. The device busy share
   is the union of the device (kernel and copy) intervals over the wall;
   K1's, K2's and K3's device time and launches, and their shares of the
   device time.
   The profiler's own "Activity Buffer Request" row in the table is a
   host event and is not among them.

Prints the card's name and power limit, the times, and the profiler's
device ops by self device time.

    python3 profile_decode.py --solve-routes

instead solves production bit 0 from the same splits (drawn on the host)
three ways — through the kernels, through their plain versions on the
card (cuFFT), and on the host (pocketfft) — for 1, 3 and 10 iterations,
and prints how far each pair of routes differs: the floor between two
correct FP32 implementations of the solve. The host solves take minutes.

    python3 profile_decode.py --camera-routes

instead solves the smoke's camera frame ((32, 2048, 2048), padded to (48,
2176, 2176), K6, K7 and K8 in every convolution) from one seed three
ways — through the kernels, through their plain versions (cuFFT, float32)
and through the plain versions with complex128 transforms — for 1 and 10
iterations, and prints how far each pair differs: the floor of the
camera-frame solve limits in ``chip_smoke.py``. Then it profiles the
kernels' solve for 2 iterations: device time by kernel (K6, K7's two
passes, K8, K4, K5, copies, the rest) and the device busy share.

    python3 profile_decode.py --camera-pair

instead times the camera geometry alone: the smoke's bead pair through
``register_pair_to_fixed`` twice (the first run also uploads constants
and plans ``torch.fft``), the camera frame's solve through the kernels,
and K6, K7 and K8 at the frame's shapes against their plain versions. It
calls only ``chip_smoke`` functions that predate K6's and K7's radix
designs, so a copy of this file in a checkout of an older commit times
that commit: run both checkouts in one call, in turns, to compare them on
one card.

    python3 profile_decode.py --lead-routes

instead times K8 at every length of its radix route on a (n, 1024, 1024)
complex pair of random data, forward, through the kernel its route
launches (``dft_lead_radix``) and through K10's z pass, which every other
length takes, with the byte bound: the measurement behind the route map.

    python3 profile_decode.py --decode-kernels

instead times K1, K2 and K3 on the production tile with the settings of
``chip_smoke.py``'s decode checks: K3 on the first 8-plane chunk of the
tile's lowpass, packed and as the view ``decode_volume`` passes (an
older checkout that refuses the view says so), K1 on the tile (CUDA
events around the wrapper, and its device time under the profiler), K2
on the plain K1 output of the tile, and ``decode_volume``'s wall over the
whole lowpassed tile;
then K2's and K3's device time under the profiler, with all codewords and
with the first alone (the work outside the codebook loop).
It calls only wrappers that predate this mode, so a copy of this file in
a checkout of an older commit times that commit: run both checkouts in
one call, in turns, to compare them on one card.

    python3 profile_decode.py --k1-tiling

instead builds edited copies of K1's source (``csrc/fused_decode.cu``):
its ring of staged planes at 3, 4, its own depth and 8 planes, and one
that runs a quarter of the z fold's FMAs (wrong sums: a probe of what the
fold's arithmetic costs); checks each against the library's K1 bit for
bit on a random production-shape tile (16, 16, 1024, 1024) and times
each (the kernel alone, CUDA events, medians of 20, two passes in turn),
beside the byte bound and ``torch``'s ``copy_`` of the same bytes.

    python3 profile_decode.py --flow

instead renders the deformed production tile (``chip_smoke.py`` phase
10's input), registers it as phase 10 does (readout RLGC, 10 iterations,
DoG, deformable flow) and then
times one round's flow estimate (round 1, the default
``SofimaRegistrationConfig``) by part, from the port's ``flow.*`` spans
(tracing on): the patch cross-correlation passes, the host cleaning, the
relaxation (and its sweeps, ``flow.sweeps``), the re-warp, and the
estimate's own time beside them (the composition, medians, uploads);
spans time the host without synchronizing, so a part's device work may
be waited for in the next (means of 3 estimates after a warm-up), then
one estimate under ``torch.profiler``; then where the field is right:
each moving round's first even bit warped by its affine alone and with
the flow, its isolated spots against their true positions, and round
1's valid sites split by whether their patch holds a bead, each group's
spread about the median; then one decode-style flow warp of the tile's 16 bits
(``warp_bit_images_to_reference``) under ``torch.profiler``: wall, device
busy share and the top device ops; last, phase 10's decode of the store
with its flow fields and again without them (F1 of each).

    python3 profile_decode.py --ufish

instead runs the full-width c32 U-FISH predictor (seeded weights, the
ConvTranspose decoder, as ``chip_smoke.py`` loads it) over the first 64
planes of the production tile (8 batches of 8 planes of 1024²) under
``torch.profiler``, after a warm-up batch: the wall, the device busy
share, and device time by group — K11, the per-plane normalization (sort,
percentile gather and arithmetic), reflect padding, max-pool,
concatenation, casts and copies (bf16 casts, depth-to-space) — with the
profiler's table.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import time

import chip_smoke

# the decode kernels by the fragment of their device names
DECODE_KERNELS = (("zy_lowpass", "K1 zy_lowpass"), ("x_lowpass_decode", "K2 x_lowpass_decode"),
                  ("decode_chunk", "K3 decode_chunk"))


def sectioned_run(raw) -> tuple[dict, float, float]:
    """The decode stage on a fresh store with the port's tracing on:
    (the registry's snapshot, optimization s, final-decode s)."""
    from merfish3d_tpu_torch.utils import profiling

    store = chip_smoke.registered_store(raw)
    profiling.enable()
    profiling.reset()
    try:
        _, t_opt, t_final = chip_smoke.decode_stage(store)
        return profiling.snapshot(), t_opt, t_final
    finally:
        profiling.enable(False)
        profiling.reset()


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


def device_rows(events, table, other: str) -> tuple[dict, dict]:
    """Device ms and launches of each row of ``table`` ((name fragment,
    label) pairs, the first match wins; ``other`` for the rest)."""
    from torch.autograd import DeviceType

    rows: dict = collections.defaultdict(float)
    calls: dict = collections.defaultdict(int)
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        label = next((lab for frag, lab in table if frag in e.name), other)
        rows[label] += (e.time_range.end - e.time_range.start) * 1e-3
        calls[label] += 1
    return rows, calls


def profile_registration(raw) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    log = chip_smoke.log
    reg = DataRegistration(convert_data(raw), device="cuda", decon_fiducial=False,
                           decon_readout=False, ufish_model="dog")
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


# device kernels by name fragment -> row of the decon breakdown (first
# match). K9 is three launches: K7's pass A forward and inverse around its
# conv pass; K7's own pass A (the OTF spectrum, once a batch) falls in K9's
# pass-A rows.
DECON_KERNELS = (
    ("dft_zx_x", "K10 dft_zx x pass (forward and inverse of every convolution)"),
    ("dft_zx_z", "K10 dft_zx z pass (forward and inverse of every convolution)"),
    ("dft_mid_conv_b", "K9 dft_mid_conv conv pass (dft_mid_conv_b)"),
    ("dft_middle_a<false>", "K9 dft_mid_conv pass A forward (dft_middle_a)"),
    ("dft_middle_a<true>", "K9 dft_mid_conv pass A inverse (dft_middle_a)"),
    ("ratio_kld", "K4 ratio_kld"),
    ("update_select", "K5 update_select"),
    ("dft_middle_b", "K7 dft_middle pass B (OTF spectrum)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def profile_decon(raw) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from merfish3d_tpu_torch.ops.fftutils import linear_fft_pad_width, pad_symmetric
    from merfish3d_tpu_torch.ops.rlgc import binomial_split, rlgc_batch

    log = chip_smoke.log
    psf = chip_smoke.production_psf(raw, 0)
    stack = torch.as_tensor(raw.bits[0, 0::2], device="cuda")  # bits of PSF 1, u16
    rlgc_batch(stack[:2], psf, seed=7, max_iters=2, out="device")  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, iters = rlgc_batch(stack, psf, seed=7, max_iters=10, out="device", return_iters=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = device_busy_seconds(events)
    n_iter = sum(iters)
    log(f"decon of 8 readout bits (32, 1152, 1152) padded, paired: {wall:.4f} s, iterations "
        f"{iters} ({n_iter} volume-iterations, {1e3 * wall / n_iter:.3f} ms each); device busy "
        f"{busy:.4f} s = {busy / wall:.4f} of the wall, idle (the host's share) "
        f"{1 - busy / wall:.4f}")
    rows, calls = device_rows(events, DECON_KERNELS,
                              "other elementwise and reduction ops (split sampler included)")
    dtoh = sum(e.device_type == DeviceType.CUDA and "DtoH" in e.name for e in events)
    total = sum(rows.values())
    for label, ms in sorted(rows.items(), key=lambda kv: -kv[1]):
        log(f"  {label:64s} {ms:10.3f} ms  {calls[label]:6d} launches  "
            f"{ms / n_iter:8.3f} ms a volume-iteration  {100 * ms / total:6.2f} % of device time")
    for kernel in ("K9", "K10"):
        ms = sum(v for k, v in rows.items() if k.startswith(kernel + " "))
        log(f"  {kernel} in all: {ms / n_iter:.3f} ms a volume-iteration, {100 * ms / total:.2f} % of "
            f"device time, {ms / 1e3 / wall:.4f} of the wall")
    log(f"  device-to-host copies: {dtoh} over {n_iter} volume-iterations")
    padded = pad_symmetric(stack[0].to(torch.float32), linear_fft_pad_width(stack.shape[1:], psf.shape))
    split_ms = chip_smoke.cuda_ms(lambda: binomial_split(padded, 7, 0))
    log(f"  split sampler alone (CUDA events, one volume): {split_ms:.3f} ms a call, "
        f"{split_ms * n_iter:.1f} ms over the run's volume-iterations")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))


# device kernels by name fragment -> group of the U-FISH breakdown (first match)
UFISH_KERNELS = (
    ("conv2d_same_mma_k", "K11 conv2d_same"),
    ("conv2d_same_k", "K11 conv2d_same"),
    ("Sort", "normalize: sort"),
    ("sort", "normalize: sort"),
    ("CatArrayBatchedCopy", "concatenation"),
    ("reduce_kernel", "max-pool"),
    ("index", "reflect pad and percentile gather"),
    ("gather", "reflect pad and percentile gather"),
    ("copy", "casts and copies (bf16 casts, depth-to-space)"),
    ("Memcpy", "casts and copies (bf16 casts, depth-to-space)"),
    ("Memset", "casts and copies (bf16 casts, depth-to-space)"),
)


def profile_ufish(raw) -> None:
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    log = chip_smoke.log
    with tempfile.TemporaryDirectory() as tmp:
        pred = chip_smoke.c32_predictor(Path(tmp))
    planes = torch.as_tensor(raw.bits[0, :4], device="cuda").to(torch.float32).reshape(-1, 1024, 1024)
    pred.predict_planes(planes[:8])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_planes(planes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = device_busy_seconds(events)
    n = planes.shape[0]
    log(f"c32 U-FISH over {n} planes of 1024^2 (8-plane batches): {wall:.4f} s, {n / wall:.2f} planes/s; "
        f"device busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    rows, calls = device_rows(events, UFISH_KERNELS, "other elementwise ops (normalization arithmetic)")
    total = sum(rows.values())
    for label, ms in sorted(rows.items(), key=lambda kv: -kv[1]):
        log(f"  {label:52s} {ms:10.3f} ms  {calls[label]:6d} launches  {100 * ms / total:6.2f} % of device time")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


def solve_routes(raw) -> None:
    from merfish3d_tpu_torch.ops.rlgc import binomial_split

    def host_split(observed, seed, it):
        return binomial_split(observed.cpu(), seed, it).to(observed.device)

    log = chip_smoke.log
    for iters in (1, 3, 10):
        runs = {
            "kernels": chip_smoke.solve_bit(raw, plain=False, max_iters=iters, split_fn=host_split),
            "plain on the card": chip_smoke.solve_bit(raw, plain=True, max_iters=iters, split_fn=host_split),
            "plain on the host": chip_smoke.solve_bit(raw, plain=True, max_iters=iters, device="cpu",
                                                      split_fn=host_split),
        }
        log(f"{iters} iteration(s): iterations " + ", ".join(f"{k} {v[1]} ({v[2]:.2f} s)"
                                                            for k, v in runs.items()))
        for a, b in (("kernels", "plain on the card"), ("plain on the card", "plain on the host"),
                     ("kernels", "plain on the host")):
            max_rel, l2_rel = chip_smoke.rel_delta(runs[a][0], runs[b][0])
            log(f"  {a} vs {b}: max |delta| / max |recon| {max_rel:.3e}, "
                f"||delta|| / ||recon|| {l2_rel:.3e}")


@contextlib.contextmanager
def f64_transforms():
    """Every plain transform in complex128 (the solve itself stays float32):
    a second plain route whose transforms round far less than either
    float32 route's."""
    import torch

    from merfish3d_tpu_torch.ops import pfft

    saved = pfft.axis_plain

    def axis_plain_f64(xr, xi, axis, inverse, real_output):
        xi = torch.zeros_like(xr, dtype=torch.float64) if xi is None else xi.double()
        yr, yi = saved(xr.double(), xi, axis, inverse, real_output)
        return yr.float(), None if yi is None else yi.float()

    pfft.axis_plain = axis_plain_f64
    try:
        yield
    finally:
        pfft.axis_plain = saved


# device kernels by name fragment -> row of the camera-frame breakdown
CAMERA_KERNELS = (
    ("dft_zx_x", "K6 dft_trailing (dft_zx_x, a line a block)"),
    ("dft_middle_a", "K7 dft_middle pass A (dft_middle_a, n1-point stage)"),
    ("dft_middle_b", "K7 dft_middle pass B (dft_middle_b, 128-point FFTs)"),
    ("dft_lead_radix", "K8 dft_leading (dft_lead_radix, a column a thread)"),
    ("dft_zx_z", "K8 dft_leading, z-pass route (dft_zx_z)"),
    ("ratio_kld", "K4 ratio_kld"),
    ("update_select", "K5 update_select"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def camera_breakdown(image, psf, iters: int = 2) -> None:
    """Device time of the camera frame's solve through the kernels by
    kernel (``torch.profiler``), per iteration: K6, K7's two passes, K8,
    K4, K5, copies and the rest."""
    from torch.profiler import ProfilerActivity, profile

    log = chip_smoke.log
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = chip_smoke.camera_frame_route(image, psf, plain=False, max_iters=iters, context=lambda: prof)
    events = prof.events()
    busy = device_busy_seconds(events)
    n = sum(run["iterations"])
    log(f"camera frame through the kernels, {n} iteration(s) profiled: {run['seconds']:.3f} s, device "
        f"busy {busy:.4f} s = {busy / run['seconds']:.4f} of the wall")
    rows, calls = device_rows(events, CAMERA_KERNELS,
                              "other elementwise and reduction ops (split sampler, padding, OTF)")
    total = sum(rows.values())
    for label, ms in sorted(rows.items(), key=lambda kv: -kv[1]):
        log(f"  {label:66s} {ms:10.3f} ms  {calls[label]:6d} launches  {ms / n:9.3f} ms an iteration  "
            f"{100 * ms / total:6.2f} % of device time")


def camera_routes(raw) -> None:
    """The smoke's camera frame solved three ways from one seed: through
    the kernels, through the plain versions (cuFFT, float32) and through
    the plain versions with complex128 transforms, for 1 and 10
    iterations: how far each pair differs; then the kernels' solve's
    device time by kernel (:func:`camera_breakdown`)."""
    import torch

    log = chip_smoke.log
    t0 = time.perf_counter()
    image = torch.as_tensor(chip_smoke.camera_pair()[0], device="cuda").to(torch.float32)
    log(f"camera pair generator {time.perf_counter() - t0:.3f} s")
    psf = chip_smoke.production_psf(raw)
    for iters in (1, 10):
        runs = {
            "kernels": chip_smoke.camera_frame_route(image, psf, plain=False, max_iters=iters),
            "plain": chip_smoke.camera_frame_route(image, psf, plain=True, max_iters=iters),
            "plain, f64 transforms": chip_smoke.camera_frame_route(image, psf, plain=True, max_iters=iters,
                                                                   context=f64_transforms),
        }
        log(f"camera frame, {iters} iteration(s): " + ", ".join(
            f"{k} {v['iterations']} ({v['seconds']:.2f} s)" for k, v in runs.items()))
        for a, b in (("kernels", "plain"), ("plain", "plain, f64 transforms"),
                     ("kernels", "plain, f64 transforms")):
            max_rel, l2_rel = chip_smoke.rel_delta(runs[a]["recon"], runs[b]["recon"])
            log(f"  {a} vs {b}: max |delta| / max |recon| {max_rel:.3e}, ||delta|| / ||recon|| {l2_rel:.3e}")
        del runs
        torch.cuda.empty_cache()
    camera_breakdown(image, psf)


def camera_pair_times(raw) -> None:
    """The camera geometry alone (see the module note): pair registration
    walls, the frame's solve through the kernels, K6/K7/K8 at the frame."""
    import torch

    log = chip_smoke.log
    fixed, moving = chip_smoke.camera_pair()
    for run in ("first", "second"):
        res = chip_smoke.camera_case(fixed, moving)
        log(f"camera pair registration, {run} run: {res['seconds']:.4f} s (residual {res['residual_px']:.3f} px)")
    frame = torch.as_tensor(fixed, device="cuda").to(torch.float32)
    del fixed, moving
    psf = chip_smoke.production_psf(raw)
    run = chip_smoke.camera_frame_route(frame, psf, plain=False)
    log(f"camera frame through the kernels: {run['seconds']:.4f} s, iterations {run['iterations']}")
    torch.cuda.empty_cache()
    chip_smoke.check_camera_frame_dft(frame, psf)


def lead_routes() -> None:
    """K8 through both of its kernels at each length of the radix route
    (see the module note); the two outputs must agree within the DFT
    tolerance."""
    import numpy as np
    import torch

    from merfish3d_tpu_torch import _build
    from merfish3d_tpu_torch.ops import pfft

    log = chip_smoke.log
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n in sorted(pfft.LEAD_RADIX):
        shape = (n, 1024, 1024)
        xr, xi = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev) for _ in range(2))
        wz = torch.as_tensor(pfft.dense_z_table(n, False), device=dev)
        zr, zi = torch.empty_like(xr), torch.empty_like(xr)

        def z_pass():
            status = _build.kernels().dft_leading_f32(
                xr.data_ptr(), xi.data_ptr(), zr.data_ptr(), zi.data_ptr(), wz.data_ptr(), n, 0, wz.shape[1],
                xr[0].numel(), 0, _build.stream_handle(dev))
            _build.check(status, "dft_leading_f32")

        yr, yi = pfft.dft_leading_cuda(xr, xi)
        z_pass()
        torch.cuda.synchronize()
        scale = max(yr.abs().max().item(), yi.abs().max().item())
        err = max((yr - zr).abs().max().item(), (yi - zi).abs().max().item())
        chip_smoke.require(err <= chip_smoke.DFT_RTOL * scale, f"K8's two routes disagree at n = {n}")
        radix_ms, z_ms = chip_smoke.cuda_ms(lambda: pfft.dft_leading_cuda(xr, xi)), chip_smoke.cuda_ms(z_pass)
        bound_ms = np.prod(shape) * 16 / chip_smoke.HBM_BYTES_PER_S * 1e3
        log(f"K8 n = {n} (R, M) = {pfft.LEAD_RADIX[n]} on {shape}: dft_lead_radix {radix_ms:.3f} ms, "
            f"z pass {z_ms:.3f} ms, byte bound {bound_ms:.3f} ms; routes {err / scale:.2e} x max|X| apart")
        del xr, xi, yr, yi, zr, zi
        torch.cuda.empty_cache()


def k1_tiling() -> None:
    """K1's design choices on the production tile shape (see the module
    note): edited copies of its source, each built apart and called at the
    wrapper's arguments, against the library's K1."""
    import ctypes
    import re
    import subprocess

    import torch

    from merfish3d_tpu_torch import _build
    from merfish3d_tpu_torch.ops import fused_decode as fd

    log = chip_smoke.log
    dev = torch.device("cuda")
    source = (_build.SRC_DIR / "fused_decode.cu").read_text()
    stages = int(re.search(r"constexpr int kZyStages = (\d+);", source).group(1))
    variants = {f"ring of {n} planes": [(f"kZyStages = {stages};", f"kZyStages = {n};")]
                for n in (3, 4, stages, 8)}
    variants["a quarter of the fold's FMAs (wrong sums)"] = [("if (4 * g < nz) {", "if (4 * g < 4) {")]
    out_dir = _build.BUILD_DIR / "k1_tiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "decode_core.cuh").write_text((_build.SRC_DIR / "decode_core.cuh").read_text())
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = source
        for old, new in edits:
            chip_smoke.require(old in text, f"{old!r} not in fused_decode.cu")
            text = text.replace(old, new)
        (out_dir / f"v{i}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", str(out_dir / f"v{i}.cu"),
             "-o", str(out_dir / f"v{i}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    argtypes = _build.kernels().zy_lowpass_f32.argtypes
    for i, (name, p) in enumerate(procs.items()):
        log_text = p.communicate()[0]
        chip_smoke.require(p.returncode == 0, f"nvcc failed on {name}:\n{log_text[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"v{i}.so"))
        lib.zy_lowpass_f32.argtypes = argtypes
        libs[name] = lib

    shape, sigma = (16, 16, 1024, 1024), (3.0, 1.0, 1.0)
    g = torch.Generator(device=dev).manual_seed(0)
    vol = torch.rand(shape, device=dev, generator=g) * 2000
    tab = fd._zy_tables(shape[1], shape[2], sigma[0], sigma[1], dev)
    out = torch.empty_like(vol)

    def call(lib):
        status = lib.zy_lowpass_f32(
            vol.data_ptr(), tab.wz.data_ptr(), None, None, tab.taps_z, tab.ky.data_ptr(),
            tab.ymap.data_ptr(), *shape, tab.ky.numel(), out.data_ptr(), _build.stream_handle(dev))
        _build.check(status, "zy_lowpass_f32")

    ref = fd.zy_lowpass_cuda(vol, sigma)
    for name, lib in libs.items():
        call(lib)
        torch.cuda.synchronize()
        log(f"K1, {name}: outputs bit for bit the library's: {torch.equal(out, ref)}")
    times = {name: [chip_smoke.cuda_ms(lambda: call(lib), reps=20)] for name, lib in libs.items()}
    for name, lib in reversed(list(libs.items())):
        times[name].append(chip_smoke.cuda_ms(lambda: call(lib), reps=20))
    bound_ms = vol.numel() * 8 / chip_smoke.HBM_BYTES_PER_S * 1e3
    copy_ms = chip_smoke.cuda_ms(lambda: out.copy_(vol), reps=20)
    log(f"K1 on {shape}: byte bound {bound_ms:.4f} ms; torch copy_ of the tile (the same bytes) "
        f"{copy_ms:.4f} ms")
    for name, (a, b) in times.items():
        log(f"  {name}: {a:.4f} / {b:.4f} ms (first and second pass, in turn)")


def decode_kernel_times(raw) -> None:
    """K1, K2 and K3 at the main path's shapes (see the module note)."""
    import statistics

    import torch

    from merfish3d_tpu_torch.ops import decode as dec
    from merfish3d_tpu_torch.ops import fused_decode as fd
    from merfish3d_tpu_torch.ops.filters import gaussian_lowpass

    log = chip_smoke.log
    dev = torch.device("cuda")
    sigma = (3.0, 1.0, 1.0)
    thr = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=dec.caller_thresholds(4)[0])
    nbits = raw.bits.shape[1]
    codebook = raw.codebook.astype("float32")
    cbt = torch.as_tensor(dec.normalize_codebook(codebook).T.copy(), device=dev)
    bg = torch.full((nbits,), 40.0, device=dev)
    nm = torch.full((nbits,), 250.0, device=dev)
    tile = torch.as_tensor(raw.bits[0], device=dev).to(torch.float32)
    lp = gaussian_lowpass(tile, sigma=sigma)
    view = lp[:, :8].reshape(nbits, -1)
    packed = view.contiguous()
    ms = chip_smoke.cuda_ms(lambda: dec.decode_chunk_cuda(packed, cbt, bg, nm, want_scaled=False))
    log(f"K3 on the packed chunk {tuple(packed.shape)}: {ms:.4f} ms")
    try:
        ms = chip_smoke.cuda_ms(lambda: dec.decode_chunk_cuda(view, cbt, bg, nm, want_scaled=False))
        log(f"K3 on the view (bit stride {view.stride(0)}): {ms:.4f} ms")
    except ValueError as e:
        log(f"K3 on the view: refused ({e})")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode_volume(lp, codebook, bg.cpu().numpy(), nm.cpu().numpy(), return_scaled=False, **thr)
        walls.append(time.perf_counter() - t0)
    log(f"decode_volume over the lowpassed tile {tuple(lp.shape)}: median wall "
        f"{statistics.median(walls):.4f} s of 5")
    del lp, view
    ms = chip_smoke.cuda_ms(lambda: fd.zy_lowpass_cuda(tile, sigma))
    dev_ms = device_ms(lambda: fd.zy_lowpass_cuda(tile, sigma), ("zy_lowpass",))
    log(f"K1 on the tile {tuple(tile.shape)}: {ms:.4f} ms with the wrapper, device time {dev_ms:.4f} ms")
    inter = fd.zy_lowpass_plain(tile, sigma)
    ms = chip_smoke.cuda_ms(
        lambda: fd.x_lowpass_decode_cuda(inter, cbt, bg, nm, sigma_x=sigma[2], **thr))
    log(f"K2 on the K1 output {tuple(inter.shape)}: {ms:.4f} ms")
    # the kernels' own device time (no wrapper), with all codewords and with
    # the first alone: the second is the work outside the codebook loop
    one = cbt[:, :1].contiguous()
    for label, fn in (
        ("K3 packed", lambda c: dec.decode_chunk_cuda(packed, c, bg, nm, want_scaled=False)),
        ("K2", lambda c: fd.x_lowpass_decode_cuda(inter, c, bg, nm, sigma_x=sigma[2], **thr)),
    ):
        words = [device_ms(lambda: fn(c), ("decode_chunk", "x_lowpass_decode")) for c in (cbt, one)]
        log(f"{label}: device time {words[0]:.4f} ms with {cbt.shape[1]} codewords, "
            f"{words[1]:.4f} ms with one")


def device_ms(fn, fragments, reps: int = 10) -> float:
    """Mean device time in ms of the kernels whose names hold one of
    ``fragments``, over ``reps`` calls of ``fn`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows, _ = device_rows(prof.events(), [(f, "kernel") for f in fragments], "other")
    return rows["kernel"] / reps


def isolated_spots(raw, bit: int, min_gap=(3.0, 8.0, 8.0)) -> np.ndarray:
    """Ground-truth positions (px, the tile's frame) of the spots bit
    ``bit`` images with no other of its spots within ``min_gap`` (z, y,
    x) and clear of the volume's border."""
    import numpy as np

    gt = raw.ground_truth
    genes = list(raw.gene_ids)
    on = np.asarray([raw.codebook[genes.index(g), bit] > 0 for g in gt["gene_id"]])
    pts = np.column_stack([gt["z"], gt["y"], gt["x"]])[on]
    gap = np.asarray(min_gap)
    near = (np.abs(pts[:, None, :] - pts[None, :, :]) < gap).all(axis=2).sum(axis=1) > 1
    shape = np.asarray(raw.bits.shape[2:])
    inside = np.all((pts >= (3, 8, 8)) & (pts < shape - (4, 9, 9)), axis=1)
    return pts[~near & inside]


def flow_quality(raw, store, ref) -> None:
    """Where the flow field is right: each moving round's first even bit
    (no chromatic affine), warped by its round's affine alone and with the
    flow, its isolated spots' centroids against their true positions
    (median and 95th percentile of max |delta| over the axes, px); then
    round 1's first pass: the valid sites whose patch holds a round-0 bead
    and those whose patch holds none, with the spread of each group's
    vectors about the median of the valid ones."""
    import numpy as np
    import torch

    from merfish3d_tpu_torch.ops import flow, warp
    from merfish3d_tpu_torch.utils import chromatic_calibration as cal

    log = chip_smoke.log
    spacing = np.asarray(raw.voxel_size_zyx_um)
    for r in range(1, raw.fiducial.shape[1]):
        bit = 2 * r
        pts = isolated_spots(raw, bit)
        windows = np.round(pts).astype(int)
        moving = torch.as_tensor(raw.bits[0, bit], device="cuda").to(torch.float32)
        transform = store.round_transforms[(0, r)]
        field, attrs = store.flow_fields[(0, r)]
        rows = {}
        for name, vol in (
            ("affine", warp.warp_affine(moving, transform_zyx_um=transform, spacing_zyx_um=spacing,
                                        reference_shape=tuple(moving.shape))),
            ("flow", warp.warp_affine_plus_flow(moving, field, transform_zyx_um=transform, spacing_zyx_um=spacing,
                                                reference_shape=tuple(moving.shape),
                                                map_stride_zyx_px=attrs["map_stride_zyx_px"],
                                                map_box_start_xyz_px=attrs["map_box_start_xyz_px"])),
        ):
            landing = np.abs(chip_smoke.bead_centroids(vol.cpu().numpy(), windows) - pts).max(axis=1)
            rows[name] = (float(np.median(landing)), float(np.percentile(landing, 95)))
        log(f"  round {r} bit {bit}: {len(pts)} isolated spots against their true positions: affine alone "
            f"median {rows['affine'][0]:.3f} px, p95 {rows['affine'][1]:.3f}; affine + flow median "
            f"{rows['flow'][0]:.3f} px, p95 {rows['flow'][1]:.3f}")
    cfg = flow.SofimaRegistrationConfig()
    patch, stride = cfg.resolve_patch_and_stride(tuple(ref.shape))
    moving = torch.as_tensor(store.fiducial_registered[(0, 1)], device="cuda").to(torch.float32)
    vectors, ratios, sharps = flow._patch_xcorr_flow(ref, moving, patch_size=patch, strides=stride)
    valid = flow._clean_flow(vectors, ratios, sharps, cfg)
    beads = cal.detect_beads(ref)
    starts = np.stack(np.meshgrid(*[flow._lattice_starts(n, p, st) for n, p, st in zip(ref.shape, patch, stride)],
                                  indexing="ij"), axis=-1)
    holds = np.zeros(valid.shape, bool)
    for b in beads:
        holds |= np.all((starts <= b) & (b < starts + np.asarray(patch)), axis=-1)
    med = np.median(vectors[valid], axis=0)
    for name, group in (("with a bead", holds), ("without a bead", ~holds)):
        sel = valid & group
        dev = np.abs(vectors[sel] - med).max(axis=1) if sel.any() else np.zeros(1)
        log(f"  round 1 first pass, sites {name}: {int(group.sum())}, valid {int(sel.sum())}; valid vectors' "
            f"max |v - median| over the axes: median {float(np.median(dev)):.3f} px, p95 "
            f"{float(np.percentile(dev, 95)):.3f}")


def profile_flow(raw) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.ops import flow
    from merfish3d_tpu_torch.pipeline import decode_warping
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration
    from merfish3d_tpu_torch.utils import profiling

    log = chip_smoke.log
    store = convert_data(raw)
    DataRegistration(store, device="cuda", decon_fiducial=False, decon_readout=True,
                     decon_max_iters=chip_smoke.PRODUCTION_DECON_ITERS, ufish_model="dog",
                     deformable_registration=True).register_all_tiles()
    ref = torch.as_tensor(store.fiducial_corrected[(0, 0)], device="cuda").to(torch.float32)
    moving = torch.as_tensor(store.fiducial_registered[(0, 1)], device="cuda")
    flow.estimate_sofima_flow_field_xyz_px(ref, moving)  # warm-up
    walls = []
    profiling.enable()
    profiling.reset()
    try:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, meta = flow.estimate_sofima_flow_field_xyz_px(ref, moving)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    wall = sum(walls) / len(walls)
    lattice = tuple(store.flow_fields[(0, 1)][0].shape[1:])
    log(f"round 1 flow estimate (lattice {lattice} of (10, 32, 32) patches, {meta['valid_flow_vectors']} valid): "
        f"{wall:.4f} s, mean of {len(walls)} ({[round(w, 4) for w in walls]})")
    for name in ("flow.xcorr", "flow.clean", "flow.relax", "flow.warp", "flow.estimate"):
        sec = snap["spans"].get(name, {"calls": 0, "self_seconds": 0.0})
        log(f"  {name:14s} self {sec['self_seconds'] / len(walls):.4f} s an estimate "
            f"({sec['calls'] // len(walls)} calls)")
    log(f"  relaxation sweeps {snap['counters'].get('flow.sweeps', {}).get('total', 0) / len(walls):.1f} "
        f"an estimate")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow.estimate_sofima_flow_field_xyz_px(ref, moving)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof.events())
    log(f"profiled estimate: {wall:.4f} s; device busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    flow_quality(raw, store, ref)
    bits, _ = store.registered_stack(0)
    stack = torch.as_tensor(bits, device="cuda").to(torch.float32)
    decode_warping.warp_bit_images_to_reference(stack, store=store, tile=0, bits=range(stack.shape[0]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_warping.warp_bit_images_to_reference(stack, store=store, tile=0, bits=range(stack.shape[0]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof.events())
    log(f"profiled decode warp of the 16 bits (14 through their rounds' flow fields): {wall:.4f} s; device "
        f"busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    del stack
    with_flow = decode_f1(store, raw)
    store.flow_fields.clear()
    without = decode_f1(store, raw)
    log(f"decode with the flow fields: F1 {with_flow['f1']:.4f} (tp {with_flow['true_positives']} fp "
        f"{with_flow['false_positives']} fn {with_flow['false_negatives']}); the same store without them: F1 "
        f"{without['f1']:.4f} (tp {without['true_positives']} fp {without['false_positives']} fn "
        f"{without['false_negatives']})")


def decode_f1(store, raw) -> dict:
    """``chip_smoke.py`` phase 10's decode (``estimate_chromatic_affines``,
    3 iterations, ``minimum_pixels=28``) of ``store``, matched to the
    truth."""
    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels

    table = decode_pixels(store, device="cuda", minimum_pixels=28, magnitude_threshold=(0.9, 10.0), num_tiles=1,
                          num_iterations=3, estimate_chromatic_affines=True)
    return match_spots_f1(table, raw.ground_truth, radius_um=1.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import merfish3d_tpu_torch  # noqa: F401  (sets the full-f32 precision flags)

    log = chip_smoke.log
    log(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if "--k1-tiling" in sys.argv[1:]:
        k1_tiling()
        return 0
    t0 = time.perf_counter()
    flow_mode = "--flow" in sys.argv[1:]
    raw = chip_smoke.production_raw(chromatic=flow_mode,
                                    deformation_px=chip_smoke.DEFORMATION_PX if flow_mode else 0.0)
    log(f"generator {time.perf_counter() - t0:.3f} s")
    if flow_mode:
        profile_flow(raw)
        return 0
    if "--solve-routes" in sys.argv[1:]:
        solve_routes(raw)
        return 0
    if "--ufish" in sys.argv[1:]:
        profile_ufish(raw)
        return 0
    if "--camera-routes" in sys.argv[1:]:
        camera_routes(raw)
        return 0
    if "--lead-routes" in sys.argv[1:]:
        lead_routes()
        return 0
    if "--camera-pair" in sys.argv[1:]:
        camera_pair_times(raw)
        return 0
    if "--decode-kernels" in sys.argv[1:]:
        decode_kernel_times(raw)
        return 0
    profile_registration(raw)
    profile_decon(raw)
    torch.cuda.empty_cache()

    _, t_opt, t_final = chip_smoke.decode_stage(chip_smoke.registered_store(raw))
    log(f"run 1, unsectioned: optimization {t_opt:.3f} s + final {t_final:.3f} s "
        f"= {t_opt + t_final:.3f} s")

    snap, t_opt, t_final = sectioned_run(raw)
    log(f"run 2, sectioned: optimization {t_opt:.3f} s + final {t_final:.3f} s "
        f"= {t_opt + t_final:.3f} s")
    counters = snap["counters"]
    for name, sec in snap["spans"].items():
        if name.startswith("decoder."):
            moved = {c: counters.get(c, {}).get("by_span", {}).get(name, 0)
                     for c in ("copy.d2h_bytes", "copy.h2d_bytes", "copy.reads")}
            log(f"  {name:24s} {sec['calls']:3d} calls {sec['seconds']:8.4f} s, self {sec['self_seconds']:8.4f} s; "
                f"down {moved['copy.d2h_bytes'] / 2**20:8.1f} MiB, up {moved['copy.h2d_bytes'] / 2**20:8.1f} MiB, "
                f"{moved['copy.reads']} reads")

    store = chip_smoke.registered_store(raw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, t_opt, t_final = chip_smoke.decode_stage(store)
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof.events())
    log(f"run 3, profiled: optimization {t_opt:.3f} s + final {t_final:.3f} s; wall {wall:.3f} s; "
        f"device busy {busy:.4f} s = {busy / wall:.4f} of the wall")
    rows, calls = device_rows(prof.events(), DECODE_KERNELS, "other device ops")
    total = sum(rows.values())
    for _, label in (*DECODE_KERNELS, (None, "other device ops")):
        log(f"  {label:26s} {rows[label]:10.3f} ms device, {calls[label]:5d} launches, "
            f"{rows[label] / total:.4f} of the device time")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
