#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (merfish3d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each raising on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a, one process per source) and the
   native host ops (g++); then the inputs, rendered with numpy: the
   production tile and a camera-geometry bead pair;
3. each kernel against its plain torch version on the card, at the
   shapes the main path gives it (K3 on one 8-plane chunk, K1 and K2 on
   the whole production tile; K10 and K7 on the (16, 896, 896) stage-2
   crop of a production fiducial round; K6, K7 and K8 on a (32, 1920,
   1920) crop of the camera pair; K10 at the largest plane its gate
   admits), with timings (CUDA events), the bound of each and the time
   of one ``torch.fft`` call computing the same transform;
4. the hermetic F1 cases uniform-0.315um-nodecon and cells-0.315um-nodecon
   on CUDA (fiducial registration + decode), held to their pinned F1
   ±0.02;
5. the production geometry — one (16, 1024, 1024) tile × 16 bits, 2400
   spots, 8 fiducial rounds rigidly shifted by up to 2 px — through the
   port's fiducial registration and then the decode stage on CUDA: every
   recovered round shift within 0.3 px of the injected one, F1 >= 0.5,
   with wall times, voxels/s and peak device memory. Cut to what is
   ported: no deconvolution, no deformation, no chromatic aberration;
6. the camera geometry — one (32, 2048, 2048) bead pair with a known
   shift — through ``register_pair_to_fixed`` on CUDA, recovered within
   0.3 px.

The launch counts of the seven kernels are zeroed before phase 4 and
read after phase 6: every kernel must have run on the main path. The last
lines are the kernel table as JSON and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HERMETIC_PINS = {"uniform": 0.9480, "cells": 0.9474}  # tests/test_f1_matrix.py
F1_TOLERANCE = 0.02
FLOAT_RTOL = 1e-4  # f32 kernel outputs vs plain: max |err| <= 1e-4 * max |x|
F16_RTOL = 2.0**-10  # f16 outputs: at most one f16 rounding step apart
ID_MISMATCH_MAX = 1e-5  # fraction of decoded ids allowed to differ ...
NEAR_TIE = 1e-4  # ... and only where the top-2 gap or a threshold margin < this
DFT_RTOL = 3e-5  # DFT outputs vs plain: max |err| <= 3e-5 * max |X| (tests/test_pfft.py)
SHIFT_TOL_PX = 0.3  # recovered round shifts vs the injected ones (production_case.py)
CAMERA_SHIFT_PX = (0.4, 1.7, -1.3)
# the card's published peaks (H100 SXM): HBM bytes/s and FP32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    log(f"  bound: bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms")
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


# ------------------------------------------------------------------ phase 3
def _close(a, b, *, f16: bool, dist: bool = False) -> tuple[float, bool]:
    """(max |a - b|, agree). f32 outputs agree within FLOAT_RTOL·max|b|,
    f16 outputs within one f16 rounding step. A distance is compared
    through the similarity it encodes (sim = 1 - d²/2) where that is
    looser: near d = 0 a few-ulp similarity difference moves d by ~1e-3."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if f16:
        ok = diff <= F16_RTOL * b.abs() + 2.0**-24
    else:
        ok = diff <= FLOAT_RTOL * b.abs().max()
    if dist:
        ok = ok | ((a * a - b * b).abs() / 2 <= 1e-5)
    return diff.max().item(), bool(ok.all())


def _ids_agree(k_ids, p_ids, unit, mag, cbt, thr, what: str) -> None:
    """Mismatched decoded ids must be rare, and every mismatch a near-tie: the top-2
    similarity gap below NEAR_TIE, or (with thresholds) the f32 distance
    or magnitude within NEAR_TIE of its threshold."""
    import torch

    bad = torch.nonzero(k_ids.reshape(-1) != p_ids.reshape(-1)).reshape(-1)
    frac = bad.numel() / k_ids.numel()
    near = True
    if bad.numel():
        top2 = torch.topk(cbt.T @ unit[:, bad], 2, dim=0).values
        ok = (top2[0] - top2[1]) < NEAR_TIE
        if thr is not None:
            (lo, hi), d_thr = thr["magnitude_threshold"], thr["distance_threshold"]
            d = torch.sqrt(torch.clamp(2.0 - 2.0 * top2[0], min=0.0))
            m = mag.reshape(-1)[bad]
            margin = torch.stack([(d - d_thr).abs(), (m - lo).abs(), (m - hi).abs()])
            ok = ok | (margin.min(dim=0).values < NEAR_TIE)
        near = bool(ok.all())
    log(f"  {what}: id mismatches {bad.numel()} / {k_ids.numel()} ({frac:.2e}), "
        f"all near-ties: {near}")
    if thr is not None:  # the bound is on decoded (thresholded) ids
        require(frac <= ID_MISMATCH_MAX, f"{what}: id mismatch fraction {frac:.2e}")
    require(near, f"{what}: an id mismatch is not a near-tie")


def check_decode_kernels(raw) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes,
    on realistic input: the production tile's raw counts (Poisson
    background ~40, spots up to ~2000), decoded at bg 40 / norm 250."""
    import torch

    from merfish3d_tpu_torch.ops import decode as dec
    from merfish3d_tpu_torch.ops import fused_decode as fd
    from merfish3d_tpu_torch.ops import pfft
    from merfish3d_tpu_torch.ops.filters import gaussian_lowpass

    dev = torch.device("cuda")
    sigma = (3.0, 1.0, 1.0)
    thr = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=dec.caller_thresholds(4)[0])
    nbits = raw.bits.shape[1]
    cbt = torch.as_tensor(
        dec.normalize_codebook(raw.codebook.astype("float32")).T.copy(), device=dev
    )
    bg = torch.full((nbits,), 40.0, device=dev)
    nm = torch.full((nbits,), 250.0, device=dev)

    def unit_mag(lowpassed):
        s = ((lowpassed.reshape(nbits, -1) - bg[:, None]) / nm[:, None]).clamp(0.0, 1.0)
        mag = torch.sqrt(torch.sum(s * s, dim=0))
        return s / mag.clamp(min=1e-12)[None, :], mag

    def row(name, source, replaces, err, fn, plain_fn, nbytes, flops):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain_fn)
        b = bound(nbytes, flops)
        log(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}); no single torch call computes it")
        return dict(name=name, route="cuda", source=f"merfish3d_tpu_torch/csrc/{source}",
                    replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                    library_ms=None)

    tile = torch.as_tensor(raw.bits[0], device=dev).to(torch.float32)  # (bits, 16, 1024, 1024)
    words = cbt.shape[1]
    taps = {s: 2 * int(4.0 * s + 0.5) + 1 for s in sigma}  # gaussian_lowpass, truncate 4
    rows = []

    # K3 at decode_volume's chunk: 8 lowpassed planes of the tile
    traces = gaussian_lowpass(tile, sigma=sigma)[:, :8].reshape(nbits, -1).contiguous()
    log(f"K3 decode_chunk_f32 on traces {tuple(traces.shape)}")
    k = dec.decode_chunk_cuda(traces, cbt, bg, nm)
    p = dec.decode_chunk_plain(traces, cbt, bg, nm)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("dist", "mag", "scaled"), k[1:], p[1:]):
        e, ok = _close(a, b, f16=False, dist=name == "dist")
        log(f"  {name}: max abs err {e:.3e} (max |x| {b.abs().max().item():.3e}), agree: {ok}")
        require(ok, f"K3 {name} disagrees with the plain version")
        err = max(err, e)
    unit, mag = unit_mag(traces)
    _ids_agree(k[0], p[0], unit, mag, cbt, None, "K3 argmax")
    shape = (nbits, traces.shape[1])
    _ids_agree(dec.assign_pixels(*k, shape, **thr)[0], dec.assign_pixels(*p, shape, **thr)[0],
               unit, mag, cbt, thr, "K3 decoded")
    del k, p, unit, mag
    rows.append(row(
        "decode_chunk_f32 (K3)", "decode.cu", "merfish3d_tpu/ops/decode.py:96", err,
        lambda: dec.decode_chunk_cuda(traces, cbt, bg, nm, want_scaled=False),
        lambda: dec.decode_chunk_plain(traces, cbt, bg, nm, want_scaled=False),
        # reads bits x 4 B, writes id, dist, mag (12 B) a pixel; a 2 x words x bits projection
        traces.numel() * 4 + traces.shape[1] * 12, traces.numel() * 2 * words,
    ))
    del traces

    # K1, K2 and the pair on the whole tile: fused_decode_volume hands the
    # kernels the whole (bits, 16, 1024, 1024) tile, since its working set
    # (3 x 1.07 GB) fits the memory budget at production geometry
    log(f"K1 zy_lowpass_f32 on the tile {tuple(tile.shape)}")
    k_inter = fd.zy_lowpass_cuda(tile, sigma)
    inter = fd.zy_lowpass_plain(tile, sigma)
    torch.cuda.synchronize()
    e1 = (k_inter - inter).abs().max().item()
    scale = tile.abs().max().item()
    log(f"  intermediate: max abs err {e1:.3e}, relative to max|x| {e1 / scale:.3e}")
    require(e1 <= FLOAT_RTOL * scale, f"K1 error {e1:.3e} > {FLOAT_RTOL} x {scale:.1f}")
    del k_inter
    rows.append(row(
        "zy_lowpass_f32 (K1)", "fused_decode.cu", "merfish3d_tpu/ops/fused_decode.py:104", e1,
        lambda: fd.zy_lowpass_cuda(tile, sigma), lambda: fd.zy_lowpass_plain(tile, sigma),
        tile.numel() * 8, tile.numel() * 2 * (taps[sigma[0]] + taps[sigma[1]]),
    ))

    log(f"K2 x_lowpass_decode_f32 on the plain K1 output {tuple(inter.shape)}")
    kw = dict(sigma_x=sigma[2], **thr)
    k = fd.x_lowpass_decode_cuda(inter, cbt, bg, nm, **kw)
    p = fd.x_lowpass_decode_plain(inter, cbt, bg, nm, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("mag", "dist", "scaled"), k[1:], p[1:]):
        e, ok = _close(a, b, f16=True, dist=name == "dist")
        log(f"  {name} (f16): max abs err {e:.3e}, agree: {ok}")
        require(ok, f"K2 {name} disagrees with the plain version")
        err = max(err, e)
    unit, mag = unit_mag(gaussian_lowpass(inter, sigma=(0.0, 0.0, sigma[2])))
    _ids_agree(k[0], p[0], unit, mag, cbt, thr, "K2 decoded")
    del k, p, unit, mag
    rows.append(row(
        "x_lowpass_decode_f32 (K2)", "fused_decode.cu", "merfish3d_tpu/ops/fused_decode.py:155",
        err, lambda: fd.x_lowpass_decode_cuda(inter, cbt, bg, nm, **kw),
        lambda: fd.x_lowpass_decode_plain(inter, cbt, bg, nm, **kw),
        # reads bits x 4 B, writes id, mag, dist, scaled (6 + 2 x bits B) a voxel
        inter.numel() * 4 + inter[0].numel() * (6 + 2 * nbits),
        inter.numel() * 2 * (taps[sigma[2]] + words),
    ))
    del inter

    # the pair, on the tile and (the streaming path's input, for larger
    # tiles) on one y_slab=512 slab with its 2 x 4 halo rows
    for what, vol in (("the tile", tile), ("one slab", tile[:, :, :520].contiguous())):
        log(f"K1+K2 fused_lowpass_decode on {what} {tuple(vol.shape)}")
        k = fd.fused_lowpass_decode(vol, cbt, bg, nm, sigma=sigma, **thr)
        p = fd.fused_lowpass_decode_plain(vol, cbt, bg, nm, sigma=sigma, **thr)
        unit, mag = unit_mag(gaussian_lowpass(vol, sigma=sigma))
        _ids_agree(k[0], p[0], unit, mag, cbt, thr, "K1+K2 decoded")
        del k, p, unit, mag
        ms = cuda_ms(lambda: fd.fused_lowpass_decode(vol, cbt, bg, nm, sigma=sigma, **thr))
        plain_ms = cuda_ms(
            lambda: fd.fused_lowpass_decode_plain(vol, cbt, bg, nm, sigma=sigma, **thr)
        )
        log(f"  time: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return rows


def _dft_flops(shape, axes, real_input: bool) -> float:
    """FP32 operations of the transform itself, not of the kernels' design:
    5·n·log2(n) a complex line of length n, for each axis in ``axes`` (in
    the order they run), half of it for the first axis of a real input."""
    numel = float(np.prod(shape))
    per = 0.0
    for i, ax in enumerate(axes):
        per += (2.5 if real_input and i == 0 else 5.0) * np.log2(shape[ax])
    return numel * per


def check_dft(name, kernel, plain, library, xr, xi, axes, replaces, *, record=True):
    """One DFT kernel, forward on (xr, xi) and inverse on the plain
    spectrum, against its plain version within DFT_RTOL x max|X|; times,
    bound and the ``torch.fft`` yardstick of the forward. ``axes`` are in
    the order the kernel transforms them. Returns (row or None, the plain
    forward spectrum)."""
    import torch

    shape = tuple(xr.shape)
    log(f"{name} on {shape} ({'real' if xi is None else 'complex'} input), axes {axes}")
    fk, fp = kernel(xr, xi), plain(xr, xi)
    torch.cuda.synchronize()
    scale = max(fp[0].abs().max().item(), fp[1].abs().max().item())
    rms = torch.sqrt(torch.mean(fp[0] * fp[0] + fp[1] * fp[1])).item()
    err = max((fk[0] - fp[0]).abs().max().item(), (fk[1] - fp[1]).abs().max().item())
    log(f"  forward: max abs err {err:.3e}, relative to max|X| {err / scale:.3e} "
        f"(max|X| / rms|X| {scale / rms:.1f})")
    require(err <= DFT_RTOL * scale, f"{name} forward disagrees with the plain version")
    del fk
    ik, ip = kernel(*fp, inverse=True), plain(*fp, inverse=True)
    torch.cuda.synchronize()
    iscale = max(ip[0].abs().max().item(), ip[1].abs().max().item())
    ierr = max((ik[0] - ip[0]).abs().max().item(), (ik[1] - ip[1]).abs().max().item())
    log(f"  inverse: max abs err {ierr:.3e}, relative to max|x| {ierr / iscale:.3e}")
    require(ierr <= DFT_RTOL * iscale, f"{name} inverse disagrees with the plain version")
    del ik, ip
    in_bytes = xr.numel() * (4 if xi is None else 8)
    b = bound(in_bytes + xr.numel() * 8, _dft_flops(shape, axes, xi is None))
    ms, plain_ms = cuda_ms(lambda: kernel(xr, xi)), cuda_ms(lambda: plain(xr, xi))
    lib_in = xr if xi is None else torch.complex(xr, xi)
    library_ms = cuda_ms(lambda: library(lib_in))
    inv_ms = cuda_ms(lambda: kernel(*fp, inverse=True))
    inv_plain_ms = cuda_ms(lambda: plain(*fp, inverse=True))
    log(f"  time: forward kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.fft {library_ms:.3f} ms, "
        f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}); inverse kernel {inv_ms:.3f} ms, "
        f"plain {inv_plain_ms:.3f} ms")
    row = dict(name=name, route="cuda", source="merfish3d_tpu_torch/csrc/pfft.cu", replaces=replaces,
               max_abs_err=max(err, ierr), ms=ms, plain_ms=plain_ms, **b, library_ms=library_ms)
    return (row if record else None), fp


def check_dft_kernels(raw, camera_fixed) -> list[dict]:
    """The four DFT kernels at the main path's inputs: K10 then K7 on the
    (16, 896, 896) stage-2 crop of a production fiducial round; K6, K7,
    K8 in turn on the (32, 1920, 1920) crop of the camera pair; K10 at
    the largest (z, x) plane its gate admits.

    Each crop is checked less its mean. With the mean in, max|X| is the
    DC bin (~40 counts x 12.85 M voxels), and DFT_RTOL x max|X| would be
    as large as a typical noise bin; without it, max|X| is the largest
    bead-signal bin and the limit is far below every bin's magnitude."""
    import torch

    from merfish3d_tpu_torch.ops import pfft
    from merfish3d_tpu_torch.ops.registration import _static_margin

    dev = torch.device("cuda")
    fft = torch.fft.fft
    rows = []

    def crop(vol):
        nz, ny, nx = vol.shape
        my, mx = _static_margin(ny), _static_margin(nx)
        vol = vol[:, my:ny - my, mx:nx - mx]
        return (vol - vol.mean()).contiguous()

    prod = crop(torch.as_tensor(raw.fiducial[0, 1], device=dev).to(torch.float32))
    require(pfft.zx_supported(prod.shape), f"{tuple(prod.shape)} should take K10")
    row, spec = check_dft(
        "dft_zx (K10)", pfft.dft_zx_cuda, pfft.dft_zx_plain, lambda z: torch.fft.fftn(z, dim=(0, 2)),
        prod, None, (2, 0), "merfish3d_tpu/ops/pfft.py:660",
    )
    rows.append(row)
    row, _ = check_dft(
        "dft_middle (K7)", pfft.dft_middle_cuda, pfft.dft_middle_plain, lambda z: fft(z, dim=1),
        *spec, (1,), "merfish3d_tpu/ops/pfft.py:337",
    )
    rows.append(row)
    del prod, spec

    cam = crop(camera_fixed)
    require(not pfft.zx_supported(cam.shape), f"{tuple(cam.shape)} should take the per-axis kernels")
    nz, ny, nx = cam.shape
    row, spec = check_dft(
        "dft_trailing (K6)", pfft.dft_trailing_cuda, pfft.dft_trailing_plain,
        lambda z: fft(z, dim=1), cam.reshape(nz * ny, nx), None, (1,),
        "merfish3d_tpu/ops/pfft.py:203",
    )
    rows.append(row)
    spec = tuple(t.reshape(nz, ny, nx) for t in spec)
    _, spec = check_dft(
        "dft_middle (K7)", pfft.dft_middle_cuda, pfft.dft_middle_plain, lambda z: fft(z, dim=1),
        *spec, (1,), "merfish3d_tpu/ops/pfft.py:337", record=False,
    )
    row, _ = check_dft(
        "dft_leading (K8)", pfft.dft_leading_cuda, pfft.dft_leading_plain, lambda z: fft(z, dim=0),
        *spec, (0,), "merfish3d_tpu/ops/pfft.py:469",
    )
    rows.append(row)
    del cam, spec

    # the largest (z, x) plane the gate admits, bigger than a block's shared memory
    nz, nx = max(((z, 128 * n1) for z in range(2, 97) for n1 in range(2, 25)
                  if pfft.zx_supported((z, 8, 128 * n1))), key=lambda p: (p[0] * p[1], p[1]))
    log(f"K10 at the largest admitted plane ({nz}, {nx}): {nz * nx * 8 / 1024:.0f} KB per y row, "
        f"chunks {pfft.zx_chunks(nz, nx)}")
    big = torch.as_tensor(
        np.random.default_rng(0).standard_normal((nz, 64, nx)).astype(np.float32), device=dev
    )
    check_dft("dft_zx (K10)", pfft.dft_zx_cuda, pfft.dft_zx_plain,
              lambda z: torch.fft.fftn(z, dim=(0, 2)), big, None, (2, 0),
              "merfish3d_tpu/ops/pfft.py:660", record=False)
    return rows


def production_raw():
    """The production tile's raw data (numpy generator, seed 21): one
    (16, 1024, 1024) tile x 16 bits, 2400 spots, 80 genes + 10 blanks, 8
    fiducial rounds rigidly shifted by up to 2 px
    (``merfish3d_tpu/utils/production_case.py``)."""
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )

    return generate_raw_experiment(
        shape=(16, 1024, 1024), n_spots=2400, n_genes=80, n_blanks=10, seed=21,
        voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells", n_cells=12,
        axial_sigma_um=0.44, tile_offset_px=(0.0, 0.0, 1024.0 - 205.0), round_shift_px=2.0,
    )


def camera_pair(seed: int = 7):
    """A (32, 2048, 2048) camera-geometry bead pair (the port generator's
    renderer and noise, 80 beads per 1024² as in the production tile); the
    moving volume images the beads shifted by CAMERA_SHIFT_PX."""
    from merfish3d_tpu_torch.utils.simulation import _render_bit_volume

    shape = (32, 2048, 2048)
    rng = np.random.default_rng(seed)
    n = 320
    beads = np.column_stack([rng.uniform(1, shape[0] - 1, n), rng.uniform(4, shape[1] - 4, n),
                             rng.uniform(4, shape[2] - 4, n)])
    amps = rng.uniform(500, 1500, n)
    sigma = (0.44 / 0.315, 1.4, 1.4)
    return tuple(
        rng.poisson(_render_bit_volume(shape, beads + np.asarray(s), amps, sigma_zyx=sigma) + 40)
        .astype(np.uint16)
        for s in ((0.0, 0.0, 0.0), CAMERA_SHIFT_PX)
    )


# --------------------------------------------------------------- phase 4/5
def registered_store(raw):
    """ArrayStore of ``raw`` after the DoG readout stage, on CUDA."""
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(raw)
    DataRegistration(store, device="cuda").register_all_tiles()
    return store


def hermetic_case(distribution: str) -> dict:
    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels

    raw = generate_raw_experiment(
        shape=(12, 96, 96), n_spots=170 if distribution == "uniform" else 60,
        n_genes=20, n_blanks=4, seed=11, voxel_size_zyx_um=(0.315, 0.098, 0.098),
        distribution=distribution, axial_sigma_um=0.44,
    )
    table = decode_pixels(
        registered_store(raw), device="cuda", minimum_pixels=4,
        magnitude_threshold=(0.9, 10.0), lowpass_sigma=(3.0, 1.0, 1.0), num_tiles=1,
        num_iterations=2,
    )
    return match_spots_f1(table, raw.ground_truth, radius_um=1.0)


def decode_stage(store) -> tuple[dict, float, float]:
    """The production decode stage on CUDA: normalization optimization (3
    iterations) then the final decode + filter. Returns (filtered table,
    optimization s, final-decode s)."""
    import torch

    from merfish3d_tpu_torch.pipeline.decoder import PixelDecoder

    decoder = PixelDecoder(
        store, device="cuda", magnitude_threshold=(0.9, 10.0), minimum_pixels=28
    )
    t0 = time.perf_counter()
    decoder.optimize_normalization_by_decoding(
        n_random_tiles=1, n_iterations=3, lowpass_sigma=(3.0, 1.0, 1.0)
    )
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = decoder.decode_all_tiles(
        lowpass_sigma=(3.0, 1.0, 1.0), filter_method="blank_fraction", target_misid_rate=0.05
    )
    torch.cuda.synchronize()
    return table, t_opt, time.perf_counter() - t0


def round_shift_residual_px(store, raw) -> np.ndarray:
    """|recovered - injected| round shifts in px, (rounds, 3): the port's
    transform is the pull shift, which equals the injected field shift."""
    spacing = np.asarray(raw.voxel_size_zyx_um)
    rec = np.stack([store.round_transforms[(0, r)][:3, 3] / spacing
                    for r in range(len(raw.round_shifts_px_zyx))])
    return np.abs(rec - raw.round_shifts_px_zyx)


def production_case(raw) -> dict:
    import torch

    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    torch.cuda.reset_peak_memory_stats()
    store = convert_data(raw)
    reg = DataRegistration(store, device="cuda")
    seconds = {}

    def timed(name, step):
        def run(tile):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(tile)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
        return run

    # the first run also uploads constants and plans torch.fft: timed on its
    # own, then the warm run through the entry point, split by step
    timed("first", reg._generate_registrations)(0)
    reg._generate_registrations = timed("fiducial", reg._generate_registrations)
    reg._apply_registration_to_bits = timed("bits", reg._apply_registration_to_bits)
    t0 = time.perf_counter()
    reg.register_all_tiles()
    torch.cuda.synchronize()
    t_register = time.perf_counter() - t0
    residual = round_shift_residual_px(store, raw)
    table, t_opt, t_final = decode_stage(store)
    f1 = match_spots_f1(table, raw.ground_truth, radius_um=1.0)
    voxels = int(raw.bits[0, 0].size)
    return {
        "fiducial_registration_first_s": seconds["first"],
        "fiducial_registration_s": seconds["fiducial"],
        "fiducial_registration_s_per_round": seconds["fiducial"] / (raw.fiducial.shape[1] - 1),
        "max_round_shift_residual_px": float(residual.max()),
        "round_shift_residual_px": residual.round(4).tolist(),
        "register_s": t_register,
        "readout_bits_s": seconds["bits"],
        "decode_s": t_opt + t_final,
        "optimize_s": t_opt,
        "final_decode_s": t_final,
        "voxels_per_s": voxels / (t_opt + t_final),
        "bit_voxels_per_s": voxels * raw.bits.shape[1] / (t_opt + t_final),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
        "barcodes_unfiltered": int(len(store.decoded_tables[0]["gene_id"])),
        "barcodes": int(f1["n_decoded"]),
        "f1": f1,
    }


def camera_case(fixed, moving) -> dict:
    import torch

    from merfish3d_tpu_torch.ops.registration import register_pair_to_fixed

    spacing = np.asarray((0.315, 0.098, 0.098))
    f = torch.as_tensor(fixed, device="cuda").to(torch.float32)
    m = torch.as_tensor(moving, device="cuda").to(torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transform = register_pair_to_fixed(f, m, spacing_zyx_um=spacing)
    seconds = time.perf_counter() - t0
    rec = transform[:3, 3] / spacing
    return {"seconds": seconds, "recovered_px": [round(float(v), 4) for v in rec],
            "residual_px": float(np.abs(rec - np.asarray(CAMERA_SHIFT_PX)).max())}


def main() -> int:
    if importlib.util.find_spec("torch") is None:
        print("torch is not installed", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "merfish3d_tpu_torch" / "csrc").is_dir():
        print("run chip_smoke.py from the root of a merfish3d-tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # -- 1. environment
    card = card_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"card: {card}; device count {torch.cuda.device_count()}")
    for tool in ("nvcc", "g++", "ninja"):
        log(f"  {tool}: {shutil.which(tool) or 'absent'}")
    for mod in ("pandas", "tensorstore", "jax"):
        log(f"  {mod}: {'present' if importlib.util.find_spec(mod) else 'absent'} (unused)")

    import merfish3d_tpu_torch  # noqa: F401  (sets the full-f32 precision flags)
    from merfish3d_tpu_torch import _build, native
    from merfish3d_tpu_torch.ops import decode as dec
    from merfish3d_tpu_torch.ops import fused_decode as fd
    from merfish3d_tpu_torch.ops import pfft

    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 must be off")

    # -- 2. build
    t0 = time.perf_counter()
    _build.kernels()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build()
    t_native = time.perf_counter() - t0
    log(f"build: CUDA kernels {t_cuda:.1f} s (nvcc {_build.last_build_seconds}), "
        f"native host ops {t_native:.1f} s")
    for line in (_build.last_build_log or "").splitlines():
        if "Compiling entry function" in line or "registers" in line:
            log(f"  {line.split(':', 1)[1].strip()}")

    # production raw data (numpy, seed 21): also the realistic kernel input
    t0 = time.perf_counter()
    raw = production_raw()
    log(f"production generator (numpy, {raw.bits.shape}): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cam_fixed, cam_moving = camera_pair()
    log(f"camera pair generator (numpy, 2 x {cam_fixed.shape}): {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain
    kernels = check_decode_kernels(raw)
    torch.cuda.empty_cache()
    kernels += check_dft_kernels(raw, torch.as_tensor(cam_fixed, device="cuda").to(torch.float32))
    torch.cuda.empty_cache()

    # -- 4 + 5 + 6. the main path, counting launches
    dec.launch_count = 0
    fd.launch_count_zy = 0
    fd.launch_count_x_decode = 0
    for name in pfft.launch_count:
        pfft.launch_count[name] = 0
    for dist_name, pin in HERMETIC_PINS.items():
        t0 = time.perf_counter()
        res = hermetic_case(dist_name)
        log(f"hermetic {dist_name}-0.315um-nodecon on CUDA: F1 {res['f1']:.4f} "
            f"(pin {pin:.4f}, tp {res['true_positives']} fp {res['false_positives']} "
            f"fn {res['false_negatives']}), {time.perf_counter() - t0:.1f} s")
        require(abs(res["f1"] - pin) <= F1_TOLERANCE, f"{dist_name} F1 off its pin")
    prod = production_case(raw)
    log(f"production geometry (1 tile (16, 1024, 1024) x 16 bits, 2400 spots, seed 21, round "
        f"shifts up to 2 px; no decon, no deformation, no chromatic) on {card}:")
    log(f"  fiducial registration of 7 moving rounds {prod['fiducial_registration_s']:.3f} s "
        f"({prod['fiducial_registration_s_per_round']:.3f} s a round; first run "
        f"{prod['fiducial_registration_first_s']:.3f} s); max round-shift residual "
        f"{prod['max_round_shift_residual_px']:.3f} px (per round, z y x: "
        f"{prod['round_shift_residual_px']})")
    log(f"  register_all_tiles (fiducials + DoG readout {prod['readout_bits_s']:.3f} s) "
        f"{prod['register_s']:.2f} s; decode stage "
        f"{prod['decode_s']:.2f} s = optimization {prod['optimize_s']:.2f} s + final decode "
        f"{prod['final_decode_s']:.2f} s")
    log(f"  {prod['voxels_per_s']:.4g} voxels/s ({prod['bit_voxels_per_s']:.4g} bit-voxels/s) "
        f"over the decode stage; peak device memory {prod['peak_device_bytes'] / 2**30:.2f} GiB")
    log(f"  barcodes {prod['barcodes']} (unfiltered {prod['barcodes_unfiltered']}); "
        f"F1 {prod['f1']['f1']:.4f} (tp {prod['f1']['true_positives']} "
        f"fp {prod['f1']['false_positives']} fn {prod['f1']['false_negatives']})")
    require(prod["max_round_shift_residual_px"] <= SHIFT_TOL_PX,
            "a production round shift was not recovered within 0.3 px")
    require(prod["barcodes"] > 0, "no barcode decoded at production geometry")
    require(prod["f1"]["f1"] >= 0.5, "production F1 below 0.5")

    # -- 6. camera geometry pair
    camera = camera_case(cam_fixed, cam_moving)
    log(f"camera geometry pair (32, 2048, 2048), injected shift {CAMERA_SHIFT_PX} px: recovered "
        f"{camera['recovered_px']} px in {camera['seconds']:.3f} s (residual "
        f"{camera['residual_px']:.3f} px)")
    require(camera["residual_px"] <= SHIFT_TOL_PX, "the camera pair's shift was not recovered")

    launches = {
        "decode_chunk_f32 (K3)": dec.launch_count,
        "zy_lowpass_f32 (K1)": fd.launch_count_zy,
        "x_lowpass_decode_f32 (K2)": fd.launch_count_x_decode,
        "dft_trailing (K6)": pfft.launch_count["dft_trailing"],
        "dft_middle (K7)": pfft.launch_count["dft_middle"],
        "dft_leading (K8)": pfft.launch_count["dft_leading"],
        "dft_zx (K10)": pfft.launch_count["dft_zx"],
    }
    log(f"launch counts on the main path: {launches}")
    require(all(n > 0 for n in launches.values()), "a kernel of the path never launched")

    for row in kernels:
        row["launches"] = launches[row["name"]]
    summary = {"production": {k: v for k, v in prod.items() if k != "f1"}, "camera_pair": camera}
    summary["production"]["f1"] = prod["f1"]["f1"]
    log(json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
