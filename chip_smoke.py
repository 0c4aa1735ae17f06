#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (merfish3d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each raising on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a, one process per source) and the
   native host ops (g++); then the inputs, rendered with numpy: the
   production tile and a camera-geometry bead pair;
3. each kernel against its plain torch version on the card, at the
   shapes the main path gives it (K3 on one 8-plane chunk, packed and as
   the view ``decode_volume`` passes, with the V route and the codebook's
   padding logged; K1 (its route logged: segment rows, columns, shared
   bytes, blocks an SM) and K2 on the whole production tile; K10 and K7
   on the (16, 896, 896) stage-2 crop of a production fiducial round; K6,
   K7 and K8 on a (32, 1920, 1920) crop of the camera pair; K10 at the
   largest plane its gate admits; K10, K9, K4 and K5 on the first RLGC iteration of a production
   readout bit padded to (32, 1152, 1152)), with timings (CUDA events), the
   bound of each and the time of one ``torch`` call or composition
   computing the same function (K7's and K10's two passes, K9's three
   and the kernel of K8's route also apart, by the profiler; K8 also at
   the largest length it takes, 96, checked only); K11 at each distinct
   convolution of one
   8-plane batch of the production tile through a full-width c32
   ConvTranspose U-FISH network (seeded weights), on the activations that
   batch gives each layer, with the weights packed as the network holds
   them: each layer's route (the tensor-core kernel for every bf16 layer),
   TFLOP/s and the batch's sum; the component labeller on the production
   tile's decoded volume from a pass (K3) and from the final decode
   (K1+K2), its roots equal to the plain labeller's, and the float64
   component sums over the final decode's components within the size
   window, unweighted and weighted, bit for bit equal to their plain
   version on the host;
4. the twelve hermetic DoG F1 cases of the standard and exhaustive
   matrices ({uniform, cells} x {0.315, 1.0, 1.5 um axial} x {no-decon,
   decon}: fiducial registration + decode, with RLGC on the readout bits
   for 12 iterations in the decon cases, each with its matrix case's
   depth, component floor, lowpass and match radius, as
   ``tests/f1_matrix_common.py`` runs them) and the two CNN cases
   (uniform-0.315um-nodecon, cells-0.315um-decon with the repo's trained
   c8 U-FISH checkpoint) on CUDA, each held to its pinned F1 ±0.02;
5. the production geometry — one (16, 1024, 1024) tile × 16 bits, 2400
   spots, 8 fiducial rounds rigidly shifted by up to 2 px — through the
   port's fiducial registration and then the decode stage on CUDA, once
   without deconvolution and once with RLGC on the readout bits (10
   iterations, the reference's production setting): every recovered
   round shift within 0.3 px of the injected one, F1 >= 0.5, with wall
   times, voxels/s, the decon's iterations and ms per iteration and
   volume, and peak device memory; then once more without deconvolution
   with the c8 CNN predicting the spot probabilities; then the fiducial
   rounds alone registered with RLGC on the fiducials (10 iterations,
   ``decon_fiducial=True``), every round within 0.3 px; then the tile's 16
   bits x 16 planes through the full-width c32 network (seeded weights,
   encoded to ONNX and loaded as a published checkpoint would be: its
   seconds, planes/s and peak memory; random weights give meaningless
   maps, so it is not decoded). Cut to what is ported: no deformation, no
   chromatic aberration (phase 8 adds it);
6. the camera geometry — one (32, 2048, 2048) bead pair with a known
   shift — through ``register_pair_to_fixed`` on CUDA, recovered within
   0.3 px;
7. each affine warp class (translation, diagonal, general) over the
   production tile's 16-bit device stack, timed, and on two bits held to
   the CPU port within 1e-5 · max;
8. the production tile rendered with the production chromatic injection
   (translation (0.18, 0.42, -0.31) um, y/x scale 0.9982 on the second
   emission channel, at the emitter; numpy in a worker process during
   the build and phase 2) through fiducial registration (DoG, no decon) and
   ``decode_pixels(estimate_chromatic_affines=True)`` with 3 iterations:
   status ``affine_estimated``, translation within 0.12 um, y/x scale
   within 0.002, F1 >= 0.5 beside phase 5's, the decode wall and the
   shares of its warps and estimates;
9. three bead channels (32, 1024, 1024) at 0.52, 0.59 and 0.67 um, the
   two others through known full affines, through
   ``run_chromatic_calibration(deconvolve=True, psf_model="vectorial")``:
   each translation within 0.08 um and linear part within 0.005 of the
   known one, RLGC iterations and walls; then the 0.67 um channel warped
   onto the reference grid with its calibration (the general class), its
   bead centroids within 0.3 px of the reference channel's;
10. the production tile with the chromatic injection and the production
   case's smooth deformation (1.2 px; rendered in a second worker process
   during the build and phase 2) through registration with RLGC on the
   readout bits (10 iterations) and deformable flow (the default
   ``SofimaRegistrationConfig``: a (2, 63, 63) lattice of (10, 32, 32)
   patches a round) and ``decode_pixels(estimate_chromatic_affines=True)``:
   every round's flow status ``ok`` (seconds and valid vectors printed),
   the registration wall beside phase 5's, the round-shift residual
   (reported), ``affine_estimated`` within 0.12 um, F1 >= 0.5 beside phase
   8's, the decode wall with its flow warps' share, peak device memory;
   each moving round's bead landing on round 0, affine alone and affine +
   flow (median and 95th percentile; the median with flow must be the
   smaller); round 1's flow field on the card against the CPU port (first
   pass's validity split only at a gate's margin, fields within 0.01 px at
   sites valid in both) and its two bits' flow batch warp (within 1e-5 ·
   max).

The launch counts of the thirteen kernels are zeroed before phase 4 and
read after phase 6: every kernel must have run on the main path. They are
zeroed again before phase 8 and read after phase 9: K1, K2, K3, K4, K5,
the labeller, the sums and the DFT kernels of the bead solves must have
run on the chromatic path; and before phase 10 and read after its
registration and decode: K1, K2, K3, K4, K5, K7, K9, K10, the labeller and
the sums must have run on the deformed path.
Then one
production bit is solved twice more, through the kernels and through
their plain versions, from the same generator seed, and so is one camera
frame (the pair's fixed volume, padded to (48, 2176, 2176): K6, K7 and K8
in every convolution): each pair must agree, with equal iterations; K6,
K7 and K8 are then checked and timed at that frame's shapes. Last, the
same frame tiled at ``chunked_rlgc``'s default crop (``auto_crop_yx``,
1024: four tiles, each padded to (48, 1152, 1152), K10 and K9 in every
convolution) is solved through the kernels and through the plain
versions: equal iterations in every tile, and the camera-frame limits
over the whole frame and over a band of +-halo voxels around every seam.
The last lines are the kernel table as JSON and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import multiprocessing
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# tests/test_f1_matrix.py EXPECTED_F1, all twelve DoG cases of the standard
# and exhaustive matrices: (distribution, axial step um, decon) -> pinned F1
HERMETIC_PINS = {
    ("uniform", 0.315, False): 0.9480, ("cells", 0.315, False): 0.9474,
    ("uniform", 0.315, True): 0.9573, ("cells", 0.315, True): 0.9655,
    ("uniform", 1.0, False): 0.9297, ("cells", 1.0, False): 0.9474,
    ("uniform", 1.5, False): 0.9379, ("cells", 1.5, False): 0.9381,
    ("uniform", 1.0, True): 0.9541, ("cells", 1.0, True): 0.9655,
    ("uniform", 1.5, True): 0.9415, ("cells", 1.5, True): 0.9565,
}
# tests/f1_matrix_common.py MatrixCase, as plain numbers: planes per axial
# step, the component floor per plane count, spots per distribution
MATRIX_NZ = {0.315: 12, 1.0: 6, 1.5: 4}
MATRIX_MIN_PIXELS = {12: 4, 6: 3, 4: 2}
MATRIX_SPOTS = {"uniform": 170, "cells": 60}
F1_TOLERANCE = 0.02
FLOAT_RTOL = 1e-4  # f32 kernel outputs vs plain: max |err| <= 1e-4 * max |x|
F16_RTOL = 2.0**-10  # f16 outputs: at most one f16 rounding step apart
ID_MISMATCH_MAX = 1e-5  # fraction of decoded ids allowed to differ ...
NEAR_TIE = 1e-4  # ... and only where the top-2 gap or a threshold margin < this
DFT_RTOL = 3e-5  # DFT outputs vs plain: max |err| <= 3e-5 * max |X| (tests/test_pfft.py)
SHIFT_TOL_PX = 0.3  # recovered round shifts vs the injected ones (production_case.py)
KLD_RTOL = 1e-5  # K4's KLDs (FP64 fold of FP32 terms) vs the plain f32 chain
RATIO_ULPS = 2  # K4's ratios vs plain: the same division, at most 2 ulp apart
# One production bit solved through the kernels and through the plain
# versions from one seed. The consensus gate where(c < 0, recon, recon*ht)
# is discontinuous: voxels whose consensus is within rounding of zero take
# either side in any two FP32 implementations. Two plain solves of this
# bit from the same splits, cuFFT on an H100 against pocketfft on its
# host, differ by 4.4e-3 max |delta| / max |recon| and 1.4e-3 in L2 after
# 10 iterations, 9.6e-3 / 1.6e-3 after one (``profile_decode.py
# --solve-routes``). Equal iteration counts are required, and about 4x
# that floor.
SOLVE_MAX_RTOL = 2e-2
SOLVE_L2_RTOL = 5e-3
# The camera frame (32, 2048, 2048) solved the same way: a frame that is
# mostly flat background puts the consensus within rounding of zero at
# far more voxels. Two plain solves from the same splits, float32 cuFFT
# against complex128 transforms, differ by 2.6e-2 max |delta| / max
# |recon| and 6.1e-3 in L2 after one iteration, 1.3e-2 / 6.1e-3 after
# 10 (``profile_decode.py --camera-routes``, NVIDIA H100 80GB HBM3).
# Equal iteration counts are required, and about 4x that floor.
CAMERA_SOLVE_MAX_RTOL = 5e-2
CAMERA_SOLVE_L2_RTOL = 2.5e-2
# the crop auto_crop_yx picks for the camera frame under the reference's
# padded-voxel budget (ROADMAP.md, port faults)
CAMERA_DEFAULT_CROP = 1024
PRODUCTION_DECON_ITERS = 10
# DataRegistration's options for the repo's trained c8 U-FISH checkpoint,
# as tests/f1_matrix_common.py passes them
CNN_OPTIONS = dict(ufish_model="synthetic-cnn",
                   ufish_checkpoint=ROOT / "tests" / "data" / "ufish_synthetic_c8.pkl")
# tests/test_f1_matrix.py EXPECTED_F1_CNN: (distribution, axial step, decon) -> pinned F1
CNN_PINS = {("uniform", 0.315, False): 0.9666, ("cells", 0.315, True): 0.9744}
# a U-Net batch through K11 vs through the plain convolutions: the CPU
# predictor's bound against the reference's bf16 path (tests/test_torch_ufish.py)
UNET_ROUTE_ATOL = 0.05
CAMERA_SHIFT_PX = (0.4, 1.7, -1.3)
# the card's published peaks (H100 SXM): HBM bytes/s and FP32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12  # H100 SXM, non-tensor FP64
BF16_TENSOR_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate


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


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their type's peak rate (FP32
    unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
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

    def route(what):
        packed = dec.pack_codebook(cbt)
        log(f"  {what} route: V = {dec.voxels_per_thread(nbits)} voxels a thread ({nbits} bits); "
            f"codebook packed {tuple(cbt.shape)} -> {tuple(packed.shape)} "
            f"({packed.shape[1] - nbits} zero pad bits)")

    # K3 at decode_volume's chunk: 8 lowpassed planes of the tile, packed and
    # as the view decode_volume passes (rows a whole bit volume apart)
    lowpassed = gaussian_lowpass(tile, sigma=sigma)
    view = lowpassed[:, :8].reshape(nbits, -1)
    traces = view.contiguous()
    log(f"K3 decode_chunk_f32 on traces {tuple(traces.shape)}")
    route("K3")
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
    kv = dec.decode_chunk_cuda(view, cbt, bg, nm)
    same = all(torch.equal(a, b) for a, b in zip(kv, k))
    log(f"  the view (bit stride {view.stride(0)}) gives the packed chunk's outputs bit for bit: {same}")
    require(same, "K3 on the view disagrees with K3 on the packed chunk")
    del k, p, kv, unit, mag
    rows.append(row(
        "decode_chunk_f32 (K3)", "decode.cu", "merfish3d_tpu/ops/decode.py:96", err,
        lambda: dec.decode_chunk_cuda(traces, cbt, bg, nm, want_scaled=False),
        lambda: dec.decode_chunk_plain(traces, cbt, bg, nm, want_scaled=False),
        # reads bits x 4 B, writes id, dist, mag (12 B) a pixel; a 2 x words x bits projection
        traces.numel() * 4 + traces.shape[1] * 12, traces.numel() * 2 * words,
    ))
    view_ms = cuda_ms(lambda: dec.decode_chunk_cuda(view, cbt, bg, nm, want_scaled=False))
    log(f"  time on the view: kernel {view_ms:.3f} ms (packed {rows[-1]['ms']:.3f} ms)")
    del traces, view, lowpassed

    # K1, K2 and the pair on the whole tile: fused_decode_volume hands the
    # kernels the whole (bits, 16, 1024, 1024) tile, since its working set
    # (3 x 1.07 GB) fits the memory budget at production geometry
    log(f"K1 zy_lowpass_f32 on the tile {tuple(tile.shape)}")
    r = fd.zy_route(tuple(tile.shape), sigma)
    log(f"  route: {r['kernel']} kernel, segments of {r['seg_rows']} rows x {r['tile_x']} columns, "
        f"{r['smem_bytes']} shared bytes and {r['threads']} threads a block, "
        f"{r['blocks_per_sm']} blocks an SM, grid {r['grid']}")
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
        # reads and writes 4 B a voxel; the z fold's min(taps_z, Z) taps and the y taps a voxel
        tile.numel() * 8, tile.numel() * 2 * (min(taps[sigma[0]], tile.shape[1]) + taps[sigma[1]]),
    ))

    log(f"K2 x_lowpass_decode_f32 on the plain K1 output {tuple(inter.shape)}")
    route("K2")
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


def check_component_kernels(raw) -> list[dict]:
    """The labeller and the sums against their plain versions on the
    production tile decoded as in check_decode_kernels (bg 40 / norm 250)
    through the decoder's two routes: the labeller on one pass's decoded
    volume (the lowpassed tile through K3) and on the final decode's
    (K1+K2), its roots equal to the plain labeller's on the card; the sums
    over the final decode's components within the decoder's default size
    window (16..500 voxels), unweighted and with the chromatic estimator's
    weighted sums, bit for bit equal to the plain version on the host (on
    the card its ``index_add_`` adds in any order)."""
    import torch

    from merfish3d_tpu_torch.ops import components as comp
    from merfish3d_tpu_torch.ops import decode as dec
    from merfish3d_tpu_torch.ops.filters import gaussian_lowpass
    from merfish3d_tpu_torch.ops.fused_decode import fused_decode_volume

    sigma = (3.0, 1.0, 1.0)
    nbits = raw.bits.shape[1]
    kw = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=dec.caller_thresholds(4)[0])
    bg, nm = np.full(nbits, 40.0, np.float32), np.full(nbits, 250.0, np.float32)
    tile = torch.as_tensor(raw.bits[0], device="cuda").to(torch.float32)
    passed = dec.decode_volume(gaussian_lowpass(tile, sigma=sigma), raw.codebook, bg, nm,
                               return_scaled=False, on_device=True, **kw)[0]
    decoded, mag, dist, scaled = fused_decode_volume(tile, raw.codebook, bg, nm, sigma=sigma,
                                                     scaled_as="device", **kw)
    del tile
    torch.cuda.empty_cache()

    def row(name, replaces, err, fn, plain_fn, nbytes, flops, flop_rate=FP32_FLOP_PER_S):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain_fn, reps=3)
        b = bound(nbytes, flops, flop_rate)
        log(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}); no single torch call computes it")
        return dict(name=name, route="cuda", source="merfish3d_tpu_torch/csrc/components.cu",
                    replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, **b, library_ms=None)

    for what, vol in (("a pass's", passed), ("the final decode's", decoded)):
        k, p = comp.label_volume_cuda(vol), comp.label_volume_plain(vol)
        fg = int((vol >= 0).sum())
        n = int(torch.unique(k[k >= 0]).numel())
        same = torch.equal(k, p)
        log(f"label_components_i16 on {what} decoded volume {tuple(vol.shape)}: {fg} foreground voxels, "
            f"{n} components; roots equal to the plain labeller's: {same}")
        require(fg > 0, f"{what} decoded volume has no foreground")
        require(same, f"label_components_i16 disagrees with the plain labeller on {what} decoded volume")
    del k, p
    rows = [row(
        "label_components_i16", "merfish3d_tpu/native/__init__.py:163", 0.0,
        lambda: comp.label_volume_cuda(passed), lambda: comp.label_volume_plain(passed),
        # reads 2 B, writes a 4 B root a voxel
        passed.numel() * 6, 0.0,
    )]
    del passed

    lin_s, offsets, counts = comp.component_segments(comp.label_components(decoded), (16.0, 500.0))
    voxels = int(counts.sum())
    log(f"component_sums_f64 on the final decode's {counts.numel()} components within 16..500 voxels "
        f"({voxels} voxels, {nbits} {str(scaled.dtype).removeprefix('torch.')} bits)")
    require(counts.numel() > 0, "no component within the size window")
    args = (lin_s, offsets, counts, decoded, mag, dist, scaled)
    host = [t.cpu() for t in args]
    for weighted in (False, True):
        k = comp.component_sums_cuda(*args, weighted=weighted).cpu()
        p = comp.component_sums_plain(*host, weighted=weighted)
        err = float((k - p).abs().max())
        same = torch.equal(k, p)
        log(f"  {'weighted' if weighted else 'unweighted'}: {tuple(k.shape)} float64 sums, max abs err "
            f"{err:.3e} against the plain version on the host, bit for bit: {same}")
        require(same, f"component_sums_f64 ({'weighted' if weighted else 'unweighted'}) disagrees with "
                      "the plain version on the host")
        # a kept voxel: its index (8 B), magnitude, distance and bits (2 B each) read; a component: its
        # offset and count (16 B) and codeword (2 B) read and its row written; a voxel's float64
        # operations: 4 sums, 6 products and their sums, magnitude, distance, a sum a bit, and with
        # the weights 3 products and 3 sums a bit
        cols = k.shape[1]
        nbytes = voxels * (12 + 2 * nbits) + counts.numel() * (18 + 8 * cols)
        flops = voxels * (18 + nbits * (7 if weighted else 1))
        r = row("component_sums_f64", "merfish3d_tpu/ops/cc.py:219", err,
                lambda: comp.component_sums_cuda(*args, weighted=weighted),
                lambda: comp.component_sums_plain(*args, weighted=weighted), nbytes, flops, FP64_FLOP_PER_S)
        if weighted:
            rows[-1].update(weighted_ms=r["ms"], weighted_plain_ms=r["plain_ms"], weighted_bound_ms=r["bound_ms"])
        else:
            rows.append(r)
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


# every DFT timing of the run (forward and inverse), for the summary
DFT_TIMES: list[dict] = []
# the DFT wrappers whose kernels the profiler times apart: K7's and K10's
# two passes, and the kernel K8's route launches
PROFILED_DFTS = ("dft_middle_cuda", "dft_zx_cuda", "dft_leading_cuda")


def device_ms_by_kernel(fn, reps: int = 5, tries: int = 3) -> dict:
    """Device ms of one launch of each kernel ``fn()`` runs, by its symbol:
    the mean over the launches ``torch.profiler`` recorded in ``reps``
    calls, after a warm-up call (a call that launches each kernel once, as
    the DFT wrappers do, then takes their sum). A profiling window that
    recorded no device event is taken again, up to ``tries`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total: dict = {}
    count: dict = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name).split("(")[0]
                total[name] = total.get(name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-3
                count[name] = count.get(name, 0) + 1
        if total:
            break
    return {name: ms / count[name] for name, ms in total.items()}


def check_dft(name, kernel, plain, library, xr, xi, axes, replaces):
    """One DFT kernel, forward on (xr, xi) and inverse on the plain
    spectrum, against its plain version within DFT_RTOL x max|X|; times,
    bound and the ``torch.fft`` yardstick of the forward, also kept in
    DFT_TIMES. ``axes`` are in the order the kernel transforms them.
    Returns (row, the plain forward spectrum)."""
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
    passes = {}
    if kernel.__name__ in PROFILED_DFTS:
        passes = {"forward": device_ms_by_kernel(lambda: kernel(xr, xi)),
                  "inverse": device_ms_by_kernel(lambda: kernel(*fp, inverse=True))}
        for way, split in passes.items():
            log(f"  {way} passes (profiler): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    row = dict(name=name, route="cuda", source="merfish3d_tpu_torch/csrc/pfft.cu", replaces=replaces,
               max_abs_err=max(err, ierr), ms=ms, plain_ms=plain_ms, **b, library_ms=library_ms)
    DFT_TIMES.append(dict(name=name, shape=list(shape), real_input=xi is None, ms=ms, inverse_ms=inv_ms,
                          plain_ms=plain_ms, inverse_plain_ms=inv_plain_ms, library_ms=library_ms,
                          bound_ms=b["bound_ms"], max_rel_err=max(err / scale, ierr / iscale),
                          passes_ms=passes))
    return row, fp


def check_dft_kernels(raw, camera_fixed) -> list[dict]:
    """The four DFT kernels at the main path's inputs: K10 then K7 on the
    (16, 896, 896) stage-2 crop of a production fiducial round; K6, K7,
    K8 in turn on the (32, 1920, 1920) crop of the camera pair; K10 at
    the largest (z, x) plane its gate admits and K8 at the largest length
    it takes (random complex input, checked only).

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
        *spec, (1,), "merfish3d_tpu/ops/pfft.py:337",
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
    log(f"K10 at the largest admitted plane ({nz}, {nx}): {nz * nx * 8 / 1024:.0f} KB per y row")
    big = torch.as_tensor(
        np.random.default_rng(0).standard_normal((nz, 64, nx)).astype(np.float32), device=dev
    )
    check_dft("dft_zx (K10)", pfft.dft_zx_cuda, pfft.dft_zx_plain,
              lambda z: torch.fft.fftn(z, dim=(0, 2)), big, None, (2, 0),
              "merfish3d_tpu/ops/pfft.py:660")
    del big
    # K8 at the largest length it takes, through the kernel its route names
    n = 96
    require(pfft.supported_dense_axis(n) and not pfft.supported_dense_axis(n + 1), "K8's largest length")
    log(f"K8 at the largest admitted length {n}: the {pfft.leading_route(n)} route")
    gen = np.random.default_rng(1)
    xr, xi = (torch.as_tensor(gen.standard_normal((n, 256, 1024)).astype(np.float32), device=dev)
              for _ in range(2))
    check_dft("dft_leading (K8)", pfft.dft_leading_cuda, pfft.dft_leading_plain, lambda z: fft(z, dim=0),
              xr, xi, (0,), "merfish3d_tpu/ops/pfft.py:469")
    return rows


def production_psf(raw, bit: int = 0):
    """The readout PSF the production store gives ``bit`` (Gaussian,
    (15, 15, 15), at its emission wavelength; ``convert_data``)."""
    from merfish3d_tpu_torch.models.psf import make_channel_psfs

    return make_channel_psfs([float(raw.bit_wavelengths_um[bit][1])], na=raw.na, ri=raw.ri,
                             voxel_size_zyx_um=raw.voxel_size_zyx_um, shape_zyx=(15, 15, 15))[0]


def _ulps(a, b):
    """|a - b| in units of the last place of b (float32)."""
    import torch

    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    return ((a - b).abs() / spacing).max().item()


def check_rlgc_kernels(raw) -> list[dict]:
    """K10, K9, K4 and K5 at the RLGC shape: production readout bit 0
    padded to (32, 1152, 1152) with its PSF, through the first iteration
    of its solve. K10 and K9 run on the bit less its mean (with the mean
    in, max|X| is the DC bin and the limit as large as a signal bin)."""
    import torch

    from merfish3d_tpu_torch.ops import fftutils, pfft, rlgc
    from merfish3d_tpu_torch.ops import rlgc_kernels as rk

    dev = torch.device("cuda")
    psf = production_psf(raw)
    bit = torch.as_tensor(raw.bits[0, 0], device=dev).to(torch.float32)
    pad_width = fftutils.linear_fft_pad_width(tuple(bit.shape), psf.shape)
    padded = fftutils.pad_symmetric(bit, pad_width).contiguous()
    shape = tuple(padded.shape)
    require(shape == (32, 1152, 1152), f"production bit padded to {shape}")
    require(pfft.zx_supported(shape) and pfft.mid_conv_supported(shape)
            and rk.fused_elementwise_supported(shape), f"{shape} should take K10, K9, K4 and K5")
    solve = rlgc._prepare_solve(shape, psf, pad_width, dev)
    rows = []
    voxels = float(np.prod(shape))

    # K10 at the RLGC shape: in DFT_TIMES, its row stays the registration crop's
    centered = (padded - padded.mean()).contiguous()
    _, spec = check_dft("dft_zx (K10)", pfft.dft_zx_cuda, pfft.dft_zx_plain,
                        lambda z: torch.fft.fftn(z, dim=(0, 2)), centered, None, (2, 0),
                        "merfish3d_tpu/ops/pfft.py:660")

    log(f"K9 dft_mid_conv_f32 on the K10 spectrum of the bit {shape}, times its OTF")
    hr, hi = solve.otf
    k, p = pfft.dft_mid_conv_cuda(*spec, hr, hi), pfft.dft_mid_conv_plain(*spec, hr, hi)
    torch.cuda.synchronize()
    scale = max(p[0].abs().max().item(), p[1].abs().max().item())
    err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
    log(f"  max abs err {err:.3e}, relative to max|y| {err / scale:.3e}")
    require(err <= DFT_RTOL * scale, "K9 disagrees with the plain version")
    del k, p
    ms = cuda_ms(lambda: pfft.dft_mid_conv_cuda(*spec, hr, hi))
    plain_ms = cuda_ms(lambda: pfft.dft_mid_conv_plain(*spec, hr, hi))
    zc, hc = torch.complex(*spec), torch.complex(hr, hi)
    library_ms = cuda_ms(lambda: torch.fft.ifft(torch.fft.fft(zc, dim=1) * hc, dim=1))
    del zc, hc
    # reads x and h, writes y (complex pairs); a y FFT each way and a complex product
    b = bound(voxels * 24, voxels * (10.0 * np.log2(shape[1]) + 6.0))
    log(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.fft composition (fft along "
        f"y, product, ifft; no single call computes K9) {library_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    # its three launches by symbol: dft_middle_a<false>, dft_mid_conv_b, dft_middle_a<true>
    passes = device_ms_by_kernel(lambda: pfft.dft_mid_conv_cuda(*spec, hr, hi))
    log("  passes (profiler): " + ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items()))
    rows.append(dict(name="dft_mid_conv (K9)", route="cuda", source="merfish3d_tpu_torch/csrc/pfft.cu",
                     replaces="merfish3d_tpu/ops/pfft.py:536", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, **b, library_ms=library_ms))
    DFT_TIMES.append(dict(name="dft_mid_conv (K9)", shape=list(shape), real_input=False, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms, bound_ms=b["bound_ms"],
                          max_rel_err=err / scale, passes_ms={"forward": passes}))
    del spec, centered

    # the first iteration of the bit's solve (its pipeline seed, 7)
    slot = rlgc._load(0, padded, solve)
    hu = fftutils.fft_conv_full(slot.recon, solve.otf)
    split1 = rlgc.binomial_split(padded, 7, 0)
    split2 = padded - split1
    log(f"K4 ratio_kld_f32 on the first iteration's Hu and splits {shape}")
    k, p = rk.ratio_kld_cuda(hu, split1, split2, pad_width), rk.ratio_kld_plain(hu, split1, split2, pad_width)
    torch.cuda.synchronize()
    ulps = max(_ulps(k[0], p[0]), _ulps(k[1], p[1]))
    kld_rel = max(abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(k[2], p[2]))
    err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
    log(f"  ratios: max {ulps:.1f} ulp apart (max abs {err:.3e}); KLDs {[a.item() for a in k[2]]} vs "
        f"plain {[a.item() for a in p[2]]}, max relative difference {kld_rel:.3e}")
    require(ulps <= RATIO_ULPS, "K4 ratios disagree with the plain version")
    require(kld_rel <= KLD_RTOL, "K4 KLDs disagree with the plain version")
    r1, r2 = k[0], k[1]
    del k, p
    ms = cuda_ms(lambda: rk.ratio_kld_cuda(hu, split1, split2, pad_width))
    plain_ms = cuda_ms(lambda: rk.ratio_kld_plain(hu, split1, split2, pad_width))
    # reads Hu and both splits, writes both ratios; ~20 FP32 operations a
    # voxel, each log counted as one
    b = bound(voxels * 20, voxels * 20)
    log(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']}); no single torch call computes it")
    rows.append(dict(name="ratio_kld_f32 (K4)", route="cuda", source="merfish3d_tpu_torch/csrc/rlgc.cu",
                     replaces="merfish3d_tpu/ops/rlgc_kernels.py:88", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, **b, library_ms=None))

    gr, gi = fftutils.fft_conv_spec(r1, r2, solve.otf_t)
    ht1, ht2 = rlgc._split_ht(gr, gi, solve.update_norm)
    consensus = fftutils.fft_conv_full((ht1 - 1.0) * (ht2 - 1.0), solve.otf2)
    ht = ht1 + ht2
    del gr, gi, ht1, ht2, r1, r2, hu, split1, split2
    # recon after one update, prev the flat start: the select has two
    # different sources
    recon = fftutils.enforce_symmetric_boundary(torch.where(consensus < 0, slot.recon, slot.recon * ht),
                                                pad_width)
    prev = slot.recon
    err = 0.0
    for restore in (False, True):
        log(f"K5 update_select_f32 on the iteration's consensus, recon, prev and ht, restore {restore}")
        flag = torch.tensor(restore, device=dev)
        k = rk.update_select_cuda(consensus, recon, prev, ht, flag, pad_width)
        p = rk.update_select_plain(consensus, recon, prev, ht, flag, pad_width)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(k[:2], p[:2]))
        stats_k, stats_p = [t.item() for t in k[2:]], [t.item() for t in p[2:]]
        log(f"  selects equal: {same}; (count, max new, max |delta|) {stats_k} vs plain {stats_p}")
        require(same and stats_k == stats_p, "K5 disagrees with the plain version")
        del k, p
    ms = cuda_ms(lambda: rk.update_select_cuda(consensus, recon, prev, ht, flag, pad_width))
    plain_ms = cuda_ms(lambda: rk.update_select_plain(consensus, recon, prev, ht, flag, pad_width))
    # reads four volumes, writes two; ~8 FP32 operations a voxel
    b = bound(voxels * 24, voxels * 8)
    log(f"  time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']}); no single torch call computes it")
    rows.append(dict(name="update_select_f32 (K5)", route="cuda", source="merfish3d_tpu_torch/csrc/rlgc.cu",
                     replaces="merfish3d_tpu/ops/rlgc_kernels.py:160", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, **b, library_ms=None))
    return rows


def c32_predictor(workdir: Path):
    """A full-width c32 ConvTranspose U-FISH predictor on the card: weights
    from numpy seed 0 (He-normal convs, BatchNorm near identity), encoded
    as an ONNX file in ``workdir`` and loaded through ``get_predictor`` as
    a published checkpoint would be."""
    from merfish3d_tpu_torch.models.onnx_reader import encode_test_model
    from merfish3d_tpu_torch.models.ufish import get_predictor
    from merfish3d_tpu_torch.models.ufish_onnx import seeded_onnx_initializers

    path = workdir / "ufish_c32_seed0.onnx"
    path.write_bytes(encode_test_model(seeded_onnx_initializers(0)))
    pred = get_predictor(checkpoint_path=path, device="cuda")
    net = pred.net
    require(pred.kind == "cnn" and (net.base_features, net.depths, net.up_mode)
            == (32, (1, 2, 4), "convtranspose"), "the c32 checkpoint did not load as c32")
    return pred


def within_one_bf16_step(got, want) -> tuple[float, bool]:
    """(max |got - want|, agree): bf16 outputs of the same bf16 operands
    whose f32 sums ran in another order are at most one bf16 rounding step
    apart, plus 2**-20 x max|want| for outputs near zero."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0**-126)
    limit = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2.0**-20 * want.abs().max()
    return diff.max().item(), bool((diff <= limit).all())


def check_conv_kernel(raw, workdir: Path) -> tuple[dict, list[dict]]:
    """K11 against its plain version at each distinct convolution of one
    8-plane batch of the production tile (bit 0, z 0-7) through the c32
    network, on the activations and weights that batch gives the layer, in
    bf16: times, the time of one ``F.conv2d`` call (cuDNN, bf16,
    channels_last, bias in, activation not), the bound (bytes over the HBM
    rate, operations over the dense bf16 tensor rate) and the FP32-core
    floor. Returns the row of the dominant layer (3x3, 32 -> 32 at 1024²)
    and every shape's numbers."""
    import torch
    import torch.nn.functional as F

    from merfish3d_tpu_torch.models.ufish import _Conv
    from merfish3d_tpu_torch.ops import conv2d as c2

    pred = c32_predictor(workdir)
    captured: dict = {}
    uses: dict = {}  # how often the batch runs each distinct convolution

    def capture(mod, args):
        x = args[0]
        key = (*x.shape[:3], *mod.weight.shape, mod.act)
        uses[key] = uses.get(key, 0) + 1
        if key not in captured:
            captured[key] = (x.clone(), mod.weight.to(x.dtype), mod.bias.clone(), mod.act)

    hooks = [m.register_forward_pre_hook(capture) for m in pred.net.modules() if isinstance(m, _Conv)]
    try:
        planes = torch.as_tensor(raw.bits[0, 0, :8], device="cuda").to(torch.float32)
        pred.predict_planes(planes, batch_size=8)
    finally:
        for h in hooks:
            h.remove()
    require(len(captured) == 11, f"{len(captured)} distinct convolutions in the c32 batch, not 11")
    # the whole batch through K11 and through the plain version: one-step
    # bf16 differences travel through 13 layers
    got = pred.predict_planes(planes, batch_size=8)
    with plain_convs():
        want = pred.predict_planes(planes, batch_size=8)
    diff = (got - want).abs()
    log(f"c32 batch (8, 1024, 1024) through K11 and through the plain convolutions: max |dp| "
        f"{diff.max().item():.3e}, mean {diff.mean().item():.3e}, share differing "
        f"{(diff > 0).float().mean().item():.3e}")
    require(diff.max().item() <= UNET_ROUTE_ATOL, "the c32 batch's routes disagree")
    del got, want, diff
    shapes, err, dominant = [], 0.0, None
    for key, (x, wt, b, _) in captured.items():
        n, h, w, kh, kw, cin, co, act = key
        what = f"{kh}x{kw} {cin}->{co} {act} on ({n}, {h}, {w}, {cin})"
        pw = c2.pack_weights(wt)  # as the U-Net's convolutions hold them
        before = kernel_counts().get("conv2d_same_mma_bf16", 0)
        k = c2.conv2d_same_cuda(x, pw, b, act=act)
        require(kernel_counts().get("conv2d_same_mma_bf16", 0) == before + 1,
                f"K11 {what} did not take the tensor-core kernel")
        route = "tensor cores, conv2d_mma.cu"  # every bf16 layer, the narrow ones padded
        p = c2.conv2d_same_plain(x, wt, b, act=act)
        torch.cuda.synchronize()
        e, ok = within_one_bf16_step(k, p)
        require(ok, f"K11 {what} disagrees with the plain version")
        err = max(err, e)
        del k, p
        x_cl = x.permute(0, 3, 1, 2)  # NHWC bytes = channels_last NCHW
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.to(torch.bfloat16)
        ms = cuda_ms(lambda: c2.conv2d_same_cuda(x, pw, b, act=act))
        plain_ms = cuda_ms(lambda: c2.conv2d_same_plain(x, wt, b, act=act))
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, padding=kh // 2))
        flops = 2.0 * n * h * w * kh * kw * cin * co
        nbytes = 2.0 * (x.numel() + wt.numel() + n * h * w * co) + 4.0 * co
        log(f"K11 conv2d_same, {what} ({route}): max abs err {e:.3e}, within one bf16 step: {ok}")
        b_ = bound(nbytes, flops, BF16_TENSOR_FLOP_PER_S)
        fp32_floor = flops / FP32_FLOP_PER_S * 1e3
        log(f"  {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB; time: kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, F.conv2d {library_ms:.3f} ms, "
            f"bound {b_['bound_ms']:.3f} ms ({b_['bound_by']}), FP32-core floor {fp32_floor:.3f} ms")
        shapes.append(dict(layer=what, uses=uses[key], route=route, gflop=flops / 1e9, gbytes=nbytes / 1e9,
                           max_abs_err=e, ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                           library_ms=library_ms, fp32_floor_ms=fp32_floor, **b_))
        if (h, kh, cin, co) == (1024, 3, 32, 32):
            # an independent reference: the same convolution in float64
            y64 = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double().permute(3, 2, 0, 1),
                           b.double(), padding=1)
            y64 = y64.clamp(min=0.0).permute(0, 2, 3, 1)  # the layer's relu
            e64, ok64 = within_one_bf16_step(c2.conv2d_same_cuda(x, pw, b, act=act), y64)
            log(f"  against float64: max abs err {e64:.3e} (max |y| {y64.abs().max().item():.3e}), "
                f"within one bf16 step: {ok64}")
            require(ok64, "K11 disagrees with the float64 convolution")
            del y64
            dominant = dict(ms=ms, plain_ms=plain_ms, **b_, library_ms=library_ms)
        del x_cl, w_cl
    del captured, pred
    k11_ms = sum(s["uses"] * s["ms"] for s in shapes)
    lib_ms = sum(s["uses"] * s["library_ms"] for s in shapes)
    tflop = sum(s["uses"] * s["gflop"] for s in shapes) / 1e3
    log(f"K11 over one c32 batch (sum of uses x ms over the {len(shapes)} layers): {k11_ms:.3f} ms "
        f"({tflop / k11_ms * 1e3:.1f} TFLOP/s over {tflop:.3f} TFLOP); F.conv2d {lib_ms:.3f} ms")
    row = dict(name="conv2d_same (K11)", route="cuda", source="merfish3d_tpu_torch/csrc/conv2d_mma.cu",
               replaces="merfish3d_tpu/ops/conv2d.py:105", max_abs_err=err, **dominant)
    return row, shapes


def production_raw(chromatic: bool = False, shape=(16, 1024, 1024), n_spots: int = 2400,
                   deformation_px: float = 0.0):
    """The production tile's raw data (numpy generator, seed 21): one
    (16, 1024, 1024) tile x 16 bits, 2400 spots, 80 genes + 10 blanks, 8
    fiducial rounds rigidly shifted by up to 2 px
    (``merfish3d_tpu/utils/production_case.py``); with ``chromatic``, the
    second emission channel rendered through the production injection
    affine (``make_injection_affine``) at the emitter; every moving round
    smoothly deformed by up to ``deformation_px`` px."""
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import make_injection_affine

    return generate_raw_experiment(
        shape=shape, n_spots=n_spots, n_genes=80, n_blanks=10, seed=21,
        voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="cells", n_cells=12,
        axial_sigma_um=0.44, tile_offset_px=(0.0, 0.0, 1024.0 - 205.0), round_shift_px=2.0,
        deformation_px=deformation_px, chromatic_affine_zyx_um=make_injection_affine() if chromatic else None,
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
def registered_store(raw, **options):
    """ArrayStore of ``raw`` after the readout stage, on CUDA; no
    deconvolution and the DoG predictor unless ``options`` ask otherwise."""
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(raw)
    kw = dict(decon_fiducial=False, decon_readout=False, ufish_model="dog")
    kw.update(options)
    DataRegistration(store, device="cuda", **kw).register_all_tiles()
    return store


def hermetic_case(distribution: str, step: float, decon: bool, cnn: bool = False) -> dict:
    """A hermetic F1 case on CUDA at axial spacing ``step`` um, with the
    matrix case's own depth, component floor, lowpass and match radius
    (``tests/f1_matrix_common.py``); with ``decon``, RLGC on the readout
    bits for 12 iterations and none on the fiducials; with ``cnn``, the c8
    U-FISH checkpoint predicts the spot probabilities."""
    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels

    nz = MATRIX_NZ[step]
    raw = generate_raw_experiment(
        shape=(nz, 96, 96), n_spots=MATRIX_SPOTS[distribution], n_genes=20, n_blanks=4, seed=11,
        voxel_size_zyx_um=(step, 0.098, 0.098), distribution=distribution, axial_sigma_um=0.44,
    )
    store = registered_store(raw, decon_readout=decon, decon_max_iters=12, **(CNN_OPTIONS if cnn else {}))
    table = decode_pixels(
        store, device="cuda", minimum_pixels=MATRIX_MIN_PIXELS[nz],
        magnitude_threshold=(0.9, 10.0), lowpass_sigma=(max(3.0 * 0.315 / step, 0.5), 1.0, 1.0),
        num_tiles=1, num_iterations=2,
    )
    return match_spots_f1(table, raw.ground_truth, radius_um=1.5 if step >= 1.5 else 1.0)


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


class DeconRecorder:
    """Wraps the registration stage's ``rlgc_batch`` to record each
    solve's wall time (synchronized) and per-volume iteration counts; the
    solves themselves are unchanged."""

    def __init__(self):
        self.seconds = 0.0
        self.iters: list[int] = []

    def __enter__(self):
        import torch

        from merfish3d_tpu_torch.pipeline import registration

        self._module, self._fn = registration, registration.rlgc_batch

        def recorded(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, iters = self._fn(*args, return_iters=True, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.iters += list(iters)
            return out

        registration.rlgc_batch = recorded
        return self

    def __exit__(self, *exc):
        self._module.rlgc_batch = self._fn


def timed_predictor(reg, seconds: dict) -> None:
    """Wrap ``reg``'s spot predictor so that ``seconds["predictor"]`` sums
    its synchronized wall time."""
    import torch

    inner = reg._predictor
    seconds["predictor"] = 0.0

    def run(volumes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(volumes)
        torch.cuda.synchronize()
        seconds["predictor"] += time.perf_counter() - t0
        return out

    reg._predictor = run


def production_case(raw, *, decon: bool, cnn: bool = False) -> dict:
    """The production tile through registration (and, with ``decon``, RLGC
    on its readout bits, 10 iterations; with ``cnn``, the c8 U-FISH
    checkpoint as the spot predictor, else DoG) and the decode stage on
    CUDA."""
    import torch

    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    torch.cuda.reset_peak_memory_stats()
    store = convert_data(raw)
    reg = DataRegistration(store, device="cuda", decon_fiducial=False, decon_readout=decon,
                           decon_max_iters=PRODUCTION_DECON_ITERS,
                           **(CNN_OPTIONS if cnn else dict(ufish_model="dog")))
    seconds = {}
    timed_predictor(reg, seconds)

    def timed(name, step):
        def run(tile):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(tile)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
        return run

    # without decon, the first run also uploads constants and plans
    # torch.fft: timed on its own, then the warm run through the entry
    # point, split by step (the decon run follows it, warm)
    if not decon:
        timed("first", reg._generate_registrations)(0)
    reg._generate_registrations = timed("fiducial", reg._generate_registrations)
    reg._apply_registration_to_bits = timed("bits", reg._apply_registration_to_bits)
    with DeconRecorder() as solves:
        t0 = time.perf_counter()
        reg.register_all_tiles()
        torch.cuda.synchronize()
        t_register = time.perf_counter() - t0
    residual = round_shift_residual_px(store, raw)
    table, t_opt, t_final = decode_stage(store)
    f1 = match_spots_f1(table, raw.ground_truth, radius_um=1.0)
    voxels = int(raw.bits[0, 0].size)
    result = {
        "fiducial_registration_s": seconds["fiducial"],
        "fiducial_registration_s_per_round": seconds["fiducial"] / (raw.fiducial.shape[1] - 1),
        "max_round_shift_residual_px": float(residual.max()),
        "round_shift_residual_px": residual.round(4).tolist(),
        "register_s": t_register,
        "readout_bits_s": seconds["bits"],
        "predictor_s": seconds["predictor"],
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
    if decon:
        result.update({
            "decon_s": solves.seconds,
            "decon_iterations_per_bit": solves.iters,
            "decon_ms_per_iteration_per_volume": 1e3 * solves.seconds / max(sum(solves.iters), 1),
        })
    else:
        result["fiducial_registration_first_s"] = seconds["first"]
    return result


def c32_tile_case(raw, workdir: Path) -> dict:
    """The production tile's 16 bits x 16 planes through the c32 predictor
    in the readout-bit step (no decon): its seconds, planes/s and peak
    device memory; every bit's u8 map stored."""
    import torch

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(raw)
    reg = DataRegistration(store, device="cuda", decon_fiducial=False, decon_readout=False,
                           predictor=c32_predictor(workdir))
    seconds: dict = {}
    timed_predictor(reg, seconds)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg._apply_registration_to_bits(0)
    torch.cuda.synchronize()
    t_bits = time.perf_counter() - t0
    planes = raw.bits.shape[1] * raw.bits.shape[2]
    maps = [store.feature_predictor[(0, b)] for b in range(raw.bits.shape[1])]
    require(all(m.dtype == np.uint8 and m.shape == raw.bits.shape[2:] for m in maps),
            "the c32 predictor did not store every bit's u8 map")
    return {"readout_bits_s": t_bits, "predictor_s": seconds["predictor"], "planes": planes,
            "planes_per_s": planes / seconds["predictor"],
            "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
            "mean_probability_u8": float(np.mean([m.mean() for m in maps]))}


@contextlib.contextmanager
def plain_convs():
    """Run the U-Net's convolutions through K11's plain version."""
    from merfish3d_tpu_torch.models import ufish
    from merfish3d_tpu_torch.ops.conv2d import conv2d_same_plain

    saved = ufish.conv2d_same
    ufish.conv2d_same = conv2d_same_plain
    try:
        yield
    finally:
        ufish.conv2d_same = saved


@contextlib.contextmanager
def plain_versions():
    """Swap every RLGC kernel's entry point (K6-K10 and the port's module
    references to K4 and K5) for its plain version, so a solve on CUDA
    tensors runs no kernel."""
    from merfish3d_tpu_torch.ops import pfft, rlgc
    from merfish3d_tpu_torch.ops import rlgc_kernels as rk

    swaps = [(pfft, name, getattr(pfft, f"{name}_plain"))
             for name in ("dft_trailing", "dft_middle", "dft_leading", "dft_zx", "dft_mid_conv")]
    swaps += [(rlgc, "ratio_kld", rk.ratio_kld_plain), (rlgc, "update_select", rk.update_select_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def solve_bit(raw, *, plain: bool, max_iters: int = PRODUCTION_DECON_ITERS, device="cuda",
              split_fn=None):
    """Production bit 0 (seed 7) solved alone: (recon on the card,
    iterations, seconds, kernel launches)."""
    import torch

    from merfish3d_tpu_torch.ops import rlgc

    bit = torch.as_tensor(raw.bits[0, 0], device=device).to(torch.float32)
    launched = lambda: sum(kernel_counts().values())  # noqa: E731
    with plain_versions() if plain else contextlib.nullcontext():
        before = launched()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon, iters = rlgc.rlgc_batch(bit[None], production_psf(raw), seed=7, max_iters=max_iters,
                                       out="device", return_iters=True, split_fn=split_fn)
        torch.cuda.synchronize()
        return recon[0].to("cuda"), iters[0], time.perf_counter() - t0, launched() - before


def rel_delta(a, b) -> tuple[float, float]:
    """(max |a - b| / max |b|, ||a - b|| / ||b||)."""
    d = a - b
    return d.abs().max().item() / b.abs().max().item(), (d.norm() / b.norm()).item()


def solve_twice(raw) -> dict:
    """Production bit 0 solved twice on the card from one generator seed:
    through the kernels, and through the plain versions. Returns both
    iteration counts and times, max |delta| / max |recon| and
    ||delta|| / ||recon||."""
    rk_, ik, tk, lk = solve_bit(raw, plain=False)
    rp, ip, tp, lp = solve_bit(raw, plain=True)
    require(lk > 0 and lp == 0, f"kernel launches: {lk} through the kernels, {lp} through the plain versions")
    max_rel, l2_rel = rel_delta(rk_, rp)
    return {"iterations_kernels": ik, "iterations_plain": ip, "seconds_kernels": tk, "seconds_plain": tp,
            "max_rel_delta": max_rel, "l2_rel_delta": l2_rel}


def fiducial_decon_case(raw) -> dict:
    """The production tile's shifted fiducial rounds registered once on
    CUDA with RLGC on the fiducials (``decon_fiducial=True``, the default,
    10 iterations): the step's wall, the moving rounds' solves (wall and
    iterations), peak device memory and every round's shift residual."""
    import torch

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(raw)
    reg = DataRegistration(store, device="cuda", decon_fiducial=True, decon_readout=False,
                           decon_max_iters=PRODUCTION_DECON_ITERS, ufish_model="dog")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with DeconRecorder() as solves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg._generate_registrations(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    residual = round_shift_residual_px(store, raw)
    return {"fiducial_registration_s": seconds, "moving_decon_s": solves.seconds,
            "moving_decon_iterations": solves.iters,
            "max_round_shift_residual_px": float(residual.max()),
            "round_shift_residual_px": residual.round(4).tolist(),
            "peak_device_bytes": int(torch.cuda.max_memory_allocated())}


def kernel_counts() -> dict:
    """Each kernel's launches since the last reset of the port's tracing
    registry (on from the start of the smoke), by kernel: K8's by route
    (``dft_leading.radix``, ``dft_leading.z``), K11's tensor-core and
    FP32-core kernels apart."""
    from merfish3d_tpu_torch.utils import profiling

    return {name[len("launch."):]: c["total"] for name, c in profiling.snapshot()["counters"].items()
            if name.startswith("launch.")}


def camera_frame_route(image, psf, *, plain: bool, crop_yx=2048, max_iters: int = PRODUCTION_DECON_ITERS,
                       context=contextlib.nullcontext) -> dict:
    """One camera frame (a (32, 2048, 2048) volume as an image)
    deconvolved through ``chunked_rlgc`` with ``psf``, seed 7, through the
    kernels or their plain versions, inside ``context()``. By default in
    one tile (``crop_yx=2048``: it pads to (48, 2176, 2176), past K10's
    gate, so every convolution composes K6, K7 and K8); ``crop_yx=None``
    tiles it at ``chunked_rlgc``'s default crop. Returns the recon, the
    iteration counts, the wall, peak device memory, kernel launches, and
    for each tile its padded shape, iterations, wall and the launches of
    each kernel it took."""
    import torch

    from merfish3d_tpu_torch.ops import rlgc

    core = rlgc._rlgc_core
    tiles = []

    def recorded(observed, *args, **kwargs):
        before = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon, n = core(observed, *args, **kwargs)
        torch.cuda.synchronize()
        after = kernel_counts()
        tiles.append(dict(padded_shape=list(observed.shape), iterations=int(n),
                          seconds=time.perf_counter() - t0,
                          launches={k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}))
        return recon, n

    rlgc._rlgc_core = recorded
    try:
        with plain_versions() if plain else contextlib.nullcontext(), context():
            before = kernel_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rlgc.chunked_rlgc(image, psf, crop_yx=crop_yx, seed=7, max_iters=max_iters, out="device")
            torch.cuda.synchronize()
            after = kernel_counts()
            return dict(recon=out, iterations=[t["iterations"] for t in tiles], tiles=tiles,
                        seconds=time.perf_counter() - t0,
                        peak_device_bytes=int(torch.cuda.max_memory_allocated()),
                        launches=sum(after.values()) - sum(before.values()))
    finally:
        rlgc._rlgc_core = core


def camera_frame_solve(image, psf) -> dict:
    """The camera frame solved twice from one seed, through the kernels
    and through their plain versions: both walls, iteration counts, peak
    device memory and launches, and how far the two recons differ."""
    k = camera_frame_route(image, psf, plain=False)
    p = camera_frame_route(image, psf, plain=True)
    require(k["launches"] > 0 and p["launches"] == 0,
            f"kernel launches: {k['launches']} through the kernels, {p['launches']} through the plain versions")
    max_rel, l2_rel = rel_delta(k.pop("recon"), p.pop("recon"))
    return {"kernels": k, "plain": p, "max_rel_delta": max_rel, "l2_rel_delta": l2_rel}


def camera_frame_tiled(image, psf) -> dict:
    """The camera frame tiled at ``chunked_rlgc``'s default crop
    (``crop_yx=None``: ``auto_crop_yx``), solved twice from one seed,
    through the kernels and through their plain versions: both routes'
    tiles, walls and peak device memory, and how far the two recons differ
    over the whole frame and over the band of +-halo voxels around every
    seam between retained tiles."""
    import torch

    from merfish3d_tpu_torch.ops import rlgc

    nz, ny, nx = image.shape
    crop = rlgc.auto_crop_yx(tuple(image.shape), psf.shape)
    if crop != CAMERA_DEFAULT_CROP:
        log(f"  auto_crop_yx gives {crop}, not {CAMERA_DEFAULT_CROP}: the frame is tiled at {crop}")
    halo_y, halo_x = int(psf.shape[1]), int(psf.shape[2])
    tiles = rlgc.chunk_tiles(ny, nx, crop, halo_y, halo_x)
    k = camera_frame_route(image, psf, plain=False, crop_yx=None)
    p = camera_frame_route(image, psf, plain=True, crop_yx=None)
    require(len(tiles) > 1 and len(k["tiles"]) == len(p["tiles"]) == len(tiles),
            f"{len(tiles)} tiles planned, {len(k['tiles'])} and {len(p['tiles'])} solved")
    require(k["launches"] > 0 and p["launches"] == 0,
            f"kernel launches: {k['launches']} through the kernels, {p['launches']} through the plain versions")
    band = torch.zeros((ny, nx), dtype=torch.bool, device=image.device)
    seams_y = sorted({y1 for (_, y1, _, _), _ in tiles if y1 < ny})
    seams_x = sorted({x1 for (_, _, _, x1), _ in tiles if x1 < nx})
    for sy in seams_y:
        band[max(0, sy - halo_y):sy + halo_y, :] = True
    for sx in seams_x:
        band[:, max(0, sx - halo_x):sx + halo_x] = True
    kr, pr = k.pop("recon"), p.pop("recon")
    max_rel, l2_rel = rel_delta(kr, pr)
    seam_max_rel, seam_l2_rel = rel_delta(kr[:, band], pr[:, band])
    return {"crop_yx": crop, "halo_yx": [halo_y, halo_x], "seams_y": seams_y, "seams_x": seams_x,
            "retained": [list(t[0]) for t in tiles], "kernels": k, "plain": p,
            "max_rel_delta": max_rel, "l2_rel_delta": l2_rel,
            "seam_max_rel_delta": seam_max_rel, "seam_l2_rel_delta": seam_l2_rel}


def check_camera_frame_dft(image, psf) -> None:
    """K6, K7 and K8, forward and inverse, at the shapes the camera-frame
    solve gives them: the frame padded to (48, 2176, 2176), less its mean
    (K6 on its real rows, K7 and K8 on the spectra that follow)."""
    import torch

    from merfish3d_tpu_torch.ops import fftutils, pfft

    fft = torch.fft.fft
    padded = fftutils.pad_symmetric(image, fftutils.linear_fft_pad_width(tuple(image.shape), psf.shape))
    frame = (padded - padded.mean()).contiguous()
    del padded
    nz, ny, nx = frame.shape
    _, spec = check_dft("dft_trailing (K6)", pfft.dft_trailing_cuda, pfft.dft_trailing_plain,
                        lambda z: fft(z, dim=1), frame.reshape(nz * ny, nx), None, (1,),
                        "merfish3d_tpu/ops/pfft.py:203")
    del frame
    spec = tuple(t.reshape(nz, ny, nx) for t in spec)
    _, spec = check_dft("dft_middle (K7)", pfft.dft_middle_cuda, pfft.dft_middle_plain,
                        lambda z: fft(z, dim=1), *spec, (1,), "merfish3d_tpu/ops/pfft.py:337")
    check_dft("dft_leading (K8)", pfft.dft_leading_cuda, pfft.dft_leading_plain,
              lambda z: fft(z, dim=0), *spec, (0,), "merfish3d_tpu/ops/pfft.py:469")


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


# ------------------------------------------------------- phases 7 to 9: chromatic
# the production injection (convert_to_datastore.make_injection_affine)
INJECTED_TRANSLATION_UM = (0.18, 0.42, -0.31)
INJECTED_YX_SCALE = 0.9982
CHROMATIC_TRANSLATION_TOL_UM = 0.12  # tests/test_cli_e2e.py's recovery tolerance
CHROMATIC_SCALE_TOL = 0.002
BEAD_WAVELENGTHS_UM = (0.52, 0.59, 0.67)
BEAD_SHAPE = (32, 1024, 1024)
BEAD_SPACING_UM = (0.315, 0.098, 0.098)
BEAD_TRANSLATION_TOL_UM = 0.08  # tests/test_utils_misc.py's bead tolerance
BEAD_LINEAR_TOL = 0.005
BEAD_LANDING_TOL_PX = 0.3
WARP_RTOL = 1e-5  # the card's warp vs the CPU port's: max |err| <= 1e-5 * max |x|


def bead_affines() -> dict:
    """The known chromatic affine of each non-reference bead channel (µm,
    channel → reference, the calibration's convention): a few tenths of a
    µm of translation, lateral scale ~0.998, shear ~0.002."""
    out = {}
    for wl, t, scale, shear in ((0.59, (0.12, 0.28, -0.21), (0.998, 0.9985), (0.002, -0.0015)),
                                (0.67, (0.2, -0.33, 0.37), (0.9978, 0.998), (-0.002, 0.0018))):
        a = np.eye(4)
        a[:3, 3] = t
        a[1, 1], a[2, 2] = scale
        a[1, 2], a[2, 1] = shear
        out[wl] = a
    return out


def bead_channels(seed: int = 13, n_beads: int = 800, shape=BEAD_SHAPE) -> list:
    """Three bead channels (uint16 Poisson counts over a background of 40,
    the port generator's Gaussian renderer and production PSF widths): the
    reference channel at the beads' positions, each other channel at
    inv(A) of them, A its known affine."""
    from merfish3d_tpu_torch.utils.simulation import _render_bit_volume

    rng = np.random.default_rng(seed)
    spacing = np.asarray(BEAD_SPACING_UM)
    beads_px = np.column_stack([rng.uniform(3, shape[0] - 3, n_beads), rng.uniform(12, shape[1] - 12, n_beads),
                                rng.uniform(12, shape[2] - 12, n_beads)])
    amps = rng.uniform(500, 1500, n_beads)
    homo = np.concatenate([beads_px * spacing, np.ones((n_beads, 1))], axis=1)
    affines = bead_affines()
    out = []
    for wl in BEAD_WAVELENGTHS_UM:
        inv = np.linalg.inv(affines.get(wl, np.eye(4)))
        pts = (homo @ inv.T)[:, :3] / spacing
        vol = _render_bit_volume(shape, pts, amps, sigma_zyx=(0.44 / 0.315, 1.4, 1.4))
        out.append(rng.poisson(vol + 40).astype(np.uint16))
    return out


def chromatic_inputs():
    """The chromatic phases' inputs, rendered with numpy in a worker
    process while the card runs the earlier phases: the production tile
    with the injection affine at render time, and the bead channels."""
    return production_raw(chromatic=True), bead_channels()


def deformed_inputs():
    """Phase 10's input, rendered with numpy in a second worker process
    during the build and phase 2: the chromatic production tile with the
    production case's smooth deformation."""
    return production_raw(chromatic=True, deformation_px=DEFORMATION_PX)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warp_classes_case(raw) -> dict:
    """Phase 7: each warp class over the production tile's 16-bit device
    stack (CUDA events), and the card's result on two bits against the CPU
    port's."""
    import torch

    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import make_injection_affine
    from merfish3d_tpu_torch.ops import warp

    spacing = raw.voxel_size_zyx_um
    stack = torch.as_tensor(raw.bits[0], device="cuda").to(torch.float32)
    translation = np.eye(4)
    translation[:3, 3] = np.asarray((0.37, -1.6, 2.3)) * spacing
    out = {}
    for kind, affine in (("translate", translation), ("diagonal", make_injection_affine()),
                         ("general", bead_affines()[0.59])):
        transforms = np.repeat(affine[None], stack.shape[0], axis=0)
        classes = warp._affine_batch_classes(transforms, spacing, stack.shape[0])[2]
        require({k: idx.size for idx, k in classes}[kind] == stack.shape[0], f"the {kind} affine left its class")
        ms = cuda_ms(lambda: warp.warp_affine_batch_device(stack, transforms, spacing), reps=3)
        card = warp.warp_affine_batch_device(stack[:2], transforms[:2], spacing).cpu()
        host = warp.warp_affine_batch_device(stack[:2].cpu(), transforms[:2], spacing)
        err = float((card - host).abs().max() / host.abs().max())
        out[kind] = {"ms": ms, "voxels_per_s": stack.numel() / (ms * 1e-3), "max_rel_err_vs_cpu": err}
        require(err <= WARP_RTOL, f"the {kind} warp on the card disagrees with the CPU port")
    del stack
    return out


def chromatic_production_case(raw, device="cuda", minimum_pixels: int = 28, **registration) -> dict:
    """Phases 8 and 10: the production tile rendered with the injected
    chromatic aberration, through registration (DoG, no decon unless
    ``registration`` asks otherwise) and
    ``decode_pixels(estimate_chromatic_affines=True)`` with 3 iterations;
    the registration wall and the synchronized wall of each flow estimate,
    the decode stage's wall, the synchronized walls of its warps (and of
    their flow batches), its estimates and its region statistics, the
    recovered affine and F1."""
    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels
    from merfish3d_tpu_torch.pipeline import decode_warping
    from merfish3d_tpu_torch.pipeline import decoder as decoder_module
    from merfish3d_tpu_torch.pipeline import registration as registration_module
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(raw, device=device)
    walls = {"warp": [], "flow_warp": [], "estimate": [], "extract": [], "flow": []}

    def timed(module, name, key):
        inner = getattr(module, name)

        def run(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            result = inner(*args, **kwargs)
            sync(device)
            walls[key].append(time.perf_counter() - t0)
            return result
        setattr(module, name, run)
        return module, name, inner

    def restore(originals):
        for module, name, inner in originals:
            setattr(module, name, inner)

    options = dict(decon_fiducial=False, decon_readout=False, ufish_model="dog")
    options.update(registration)
    originals = [timed(registration_module, "estimate_sofima_flow_field_xyz_px", "flow")]
    try:
        sync(device)
        t0 = time.perf_counter()
        DataRegistration(store, device=device, **options).register_all_tiles()
        sync(device)
        register_s = time.perf_counter() - t0
    finally:
        restore(originals)
    originals = [timed(decode_warping, "warp_bit_images_to_reference", "warp"),
                 timed(decode_warping, "warp_affine_plus_flow_batch_device", "flow_warp"),
                 timed(decoder_module, "estimate_chromatic_affines_from_barcodes", "estimate"),
                 timed(decoder_module, "component_stats_host", "extract")]
    try:
        sync(device)
        t0 = time.perf_counter()
        table = decode_pixels(store, device=device, minimum_pixels=minimum_pixels,
                              magnitude_threshold=(0.9, 10.0), num_tiles=1, num_iterations=3,
                              estimate_chromatic_affines=True)
        sync(device)
        decode_s = time.perf_counter() - t0
    finally:
        restore(originals)
    (channel,) = [c for c in store.load_chromatic_affine_transforms_zyx_um()["channels"].values()
                  if not c["reference_channel"]]
    affine = np.asarray(channel["affine_zyx_um"])
    return {
        "store": store,
        "register_s": register_s,
        "flow_s": walls["flow"],
        "status": channel["status"],
        "affine_zyx_um": affine.round(5).tolist(),
        "translation_error_um": np.abs(affine[:3, 3] - np.asarray(INJECTED_TRANSLATION_UM)).round(4).tolist(),
        "yx_scale": [float(affine[1, 1]), float(affine[2, 2])],
        "used_pairs": channel["diagnostics"].get("path_fits", [{}])[0].get("fit", {}).get("used_pairs"),
        "decode_s": decode_s,
        "warp_s": walls["warp"],
        "flow_warp_s": walls["flow_warp"],
        "estimate_s": walls["estimate"],
        "extract_s": walls["extract"],
        "warp_share": sum(walls["warp"]) / decode_s,
        "flow_warp_share": sum(walls["flow_warp"]) / decode_s,
        "estimate_share": sum(walls["estimate"]) / decode_s,
        "extract_share": sum(walls["extract"]) / decode_s,
        "f1": match_spots_f1(table, raw.ground_truth, radius_um=1.0),
    }


def bead_calibration_case(store, channels, device="cuda") -> dict:
    """Phase 9: run_chromatic_calibration(deconvolve=True,
    psf_model="vectorial") of the bead channels into ``store`` (RLGC
    iterations and walls recorded), the recovered affines against the known
    ones, then the 0.67 µm channel warped onto the reference grid with its
    calibration (the general class) and its bead centroids against the
    reference channel's."""
    import torch

    from merfish3d_tpu_torch.ops import warp
    from merfish3d_tpu_torch.utils import chromatic_calibration as cal

    solves = {"iterations": [], "seconds": []}
    inner = cal.rlgc

    def recorded(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        out, n = inner(*args, return_iters=True, **kwargs)
        sync(device)
        solves["seconds"].append(time.perf_counter() - t0)
        solves["iterations"].append(int(n))
        return out

    vols = [torch.as_tensor(c, device=device) for c in channels]
    cal.rlgc = recorded
    try:
        sync(device)
        t0 = time.perf_counter()
        calibration = cal.run_chromatic_calibration(store, vols, BEAD_WAVELENGTHS_UM, deconvolve=True,
                                                    psf_model="vectorial", ufish_model="dog", device=device)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        cal.rlgc = inner
    result = {"calibration_s": wall, "rlgc_iterations": solves["iterations"], "rlgc_s": solves["seconds"],
              "channels": {}}
    spacing = np.asarray(BEAD_SPACING_UM)
    for wl, truth in bead_affines().items():
        ch = calibration["channels"][f"wavelength_{wl:.6f}"]
        est = np.asarray(ch["affine_zyx_um"])
        result["channels"][wl] = {
            "status": ch["status"], "pairs": ch["diagnostics"].get("n_pairs"),
            "inliers": ch["diagnostics"].get("n_inliers"),
            "translation_error_um": np.abs(est[:3, 3] - truth[:3, 3]).round(4).tolist(),
            "linear_error": float(np.abs(est[:3, :3] - truth[:3, :3]).max()),
            "affine_zyx_um": est.round(5).tolist(),
        }
    est = np.asarray(calibration["channels"]["wavelength_0.670000"]["affine_zyx_um"])
    transform = np.linalg.inv(est)
    require(warp._warp_class(warp.transform_to_pixel(transform, spacing)[0]) == "general",
            "the bead calibration is not a general affine")
    sync(device)
    t0 = time.perf_counter()
    warped = warp.warp_affine(vols[2], transform_zyx_um=transform, spacing_zyx_um=spacing,
                              reference_shape=tuple(vols[0].shape))
    sync(device)
    result["general_warp_s"] = time.perf_counter() - t0
    ref_px = cal.detect_beads(vols[0])
    got_px = cal.detect_beads(warped)
    src, tgt = cal.mutual_nearest_neighbors(got_px * spacing, ref_px * spacing, 1.0)
    windows = np.round(tgt / spacing).astype(int)
    landing = np.abs(bead_centroids(warped.cpu().numpy(), windows)
                     - bead_centroids(vols[0].to(torch.float32).cpu().numpy(), windows)).max(axis=1)
    result.update({"beads_reference": len(ref_px), "beads_warped": len(got_px), "beads_matched": len(src),
                   "landing_px_max": float(landing.max()) if len(src) else float("inf"),
                   "landing_px_median": float(np.median(landing)) if len(src) else float("inf")})
    return result


def bead_centroids(vol: np.ndarray, centers_px: np.ndarray, half=(3, 5, 5)) -> np.ndarray:
    """Centroids (px) over the (7, 11, 11) window at each of
    ``centers_px``, less the volume's median background. The landing
    check measures both volumes in the same windows: detect_beads refines
    over 3x3x3 voxels around its own peak, which locks a centroid toward
    that voxel by up to ~0.7 px where noise picks its neighbour."""
    background = float(np.median(vol))
    out = np.empty(centers_px.shape, np.float64)
    for i, c in enumerate(centers_px):
        lo = np.maximum(c - half, 0)
        hi = np.minimum(c + np.asarray(half) + 1, vol.shape)
        roi = np.clip(vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].astype(np.float64) - background, 0, None)
        grids = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
        out[i] = [(roi * g).sum() / roi.sum() for g in grids]
    return out


# ------------------------------------------------------------ phase 10: deformable flow
DEFORMATION_PX = 1.2  # merfish3d_tpu/utils/production_case.py's deformation_px
LATTICE_SITES = 2 * 63 * 63  # the default SofimaRegistrationConfig on (16, 1024, 1024)
REFERENCE_DEFORMED_RESIDUAL_PX = 0.30  # PARITY.md's two-tile deformed case (reported, not gated)
FLOW_CPU_TOL_PX = 0.01  # the card's flow vs the CPU port's at sites valid in both
FLOW_GATE_RTOL = 1e-4  # a validity decision may split only this close to its gate


def bead_landing_case(store, raw, device="cuda") -> dict:
    """Each moving round's fiducial warped onto round 0 by its affine alone
    and by its affine and flow field, its beads' centroids measured in the
    same (7, 11, 11) windows as round 0's (``bead_centroids``, at round
    0's detected beads clear of the border): the median and 95th
    percentile of max |delta| over the axes, in px."""
    import torch

    from merfish3d_tpu_torch.ops import warp
    from merfish3d_tpu_torch.utils import chromatic_calibration as cal

    spacing = np.asarray(raw.voxel_size_zyx_um)
    reference = torch.as_tensor(raw.fiducial[0, 0], device=device).to(torch.float32)
    shape = np.asarray(reference.shape)
    windows = np.round(cal.detect_beads(reference)).astype(int)
    inside = np.all((windows >= (3, 8, 8)) & (windows < shape - (3, 8, 8)), axis=1)
    windows = windows[inside]
    want = bead_centroids(reference.cpu().numpy(), windows)
    out = {"beads": int(len(windows)), "rounds": {}}
    for r in range(1, raw.fiducial.shape[1]):
        moving = torch.as_tensor(raw.fiducial[0, r], device=device).to(torch.float32)
        transform = store.round_transforms[(0, r)]
        field, attrs = store.flow_fields[(0, r)]
        warped = {
            "affine": warp.warp_affine(moving, transform_zyx_um=transform, spacing_zyx_um=spacing,
                                       reference_shape=tuple(moving.shape)),
            "flow": warp.warp_affine_plus_flow(moving, field, transform_zyx_um=transform, spacing_zyx_um=spacing,
                                               reference_shape=tuple(moving.shape),
                                               map_stride_zyx_px=attrs["map_stride_zyx_px"],
                                               map_box_start_xyz_px=attrs["map_box_start_xyz_px"]),
        }
        row = {}
        for name, vol in warped.items():
            landing = np.abs(bead_centroids(vol.cpu().numpy(), windows) - want).max(axis=1)
            row[name] = {"median_px": float(np.median(landing)), "p95_px": float(np.percentile(landing, 95))}
        out["rounds"][r] = row
    return out


def flow_card_vs_cpu(store, round_idx: int, card="cuda") -> dict:
    """One moving round's flow field on the card and through the CPU port
    on the same u16 inputs (round 0's fiducial, the round's registered
    fiducial): the first pass's statistics and validity, the fields at
    the sites valid in both; then the flow batch warp of the round's two
    bits (their composed transforms), card against CPU port."""
    import torch

    from merfish3d_tpu_torch.ops import flow, warp
    from merfish3d_tpu_torch.pipeline import decode_warping

    cfg = flow.SofimaRegistrationConfig()
    inputs = (store.fiducial_corrected[(0, 0)], store.fiducial_registered[(0, round_idx)])
    patch, stride = cfg.resolve_patch_and_stride(inputs[0].shape)
    out, passes, fields = {}, {}, {}
    for device in (card, "cpu"):
        ref, moving = (torch.as_tensor(v, device=device).to(torch.float32) for v in inputs)
        sync(device)
        t0 = time.perf_counter()
        fields[device] = flow.estimate_sofima_flow_field_xyz_px(ref, moving, cfg)
        sync(device)
        out["card_s" if device == card else "cpu_s"] = time.perf_counter() - t0
        passes[device] = flow._patch_xcorr_flow(ref, moving, patch_size=patch, strides=stride)
    (cf, cr, cs), (hf, hr, hs) = passes[card], passes["cpu"]
    card_ok = flow._clean_flow(cf, cr, cs, cfg)
    cpu_ok = flow._clean_flow(hf, hr, hs, cfg)
    near = (np.abs(hr - cfg.min_peak_ratio) <= FLOW_GATE_RTOL * cfg.min_peak_ratio) | (
        np.abs(hs - cfg.min_peak_sharpness) <= FLOW_GATE_RTOL * cfg.min_peak_sharpness)
    both = card_ok & cpu_ok
    out.update({
        "valid_card": int(card_ok.sum()), "valid_cpu": int(cpu_ok.sum()),
        "split_sites": int((card_ok != cpu_ok).sum()),
        "split_away_from_gate": int(((card_ok != cpu_ok) & ~near).sum()),
        "ratio_max_rel": float(np.max(np.abs(cr - hr) / np.maximum(np.abs(hr), 1e-12))),
        "sharpness_max_rel": float(np.max(np.abs(cs - hs) / np.maximum(np.abs(hs), 1e-12))),
        "first_pass_max_px": float(np.abs(cf - hf)[both].max()),
        "field_max_px": float(np.abs(fields[card][0] - fields["cpu"][0])[:, both].max()),
        "meta_equal": fields[card][1] == fields["cpu"][1],
    })
    bits = [b for b in range(store.num_bits) if int(store.round_of_bit[b]) == round_idx]
    transforms = np.stack([decode_warping.bit_transform_zyx_um(store, 0, b) for b in bits])
    field, attrs = store.flow_fields[(0, round_idx)]
    args = (np.stack([field] * len(bits)), transforms, store.voxel_size_zyx_um,
            np.stack([attrs["map_stride_zyx_px"]] * len(bits)), np.stack([attrs["map_box_start_xyz_px"]] * len(bits)))
    images = np.stack([store.registered[(0, b)] for b in bits]).astype(np.float32)
    on_card = warp.warp_affine_plus_flow_batch_device(torch.as_tensor(images, device=card), *args).cpu()
    host = warp.warp_affine_plus_flow_batch_device(torch.as_tensor(images), *args)
    out["warp_bits"] = bits
    out["warp_separable"] = warp._flow_batch_plan(args[1], args[2], args[0], images.shape[1:])[2] is not None
    out["warp_max_rel_err"] = float((on_card - host).abs().max() / host.abs().max())
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    # two workers render the chromatic and deformed phases' inputs with
    # numpy during the build and phase 2
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        return smoke(pool, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def reset_launch_counts() -> None:
    """Zero the port's tracing registry (its spans and counters)."""
    from merfish3d_tpu_torch.utils import profiling

    profiling.reset()


# each kernel table row's launch counters
KERNEL_ROWS = {
    "decode_chunk_f32 (K3)": ("decode_chunk_f32",),
    "zy_lowpass_f32 (K1)": ("zy_lowpass_f32",),
    "x_lowpass_decode_f32 (K2)": ("x_lowpass_decode_f32",),
    "dft_trailing (K6)": ("dft_trailing",),
    "dft_middle (K7)": ("dft_middle",),
    "dft_leading (K8)": ("dft_leading.radix", "dft_leading.z"),
    "dft_zx (K10)": ("dft_zx",),
    "dft_mid_conv (K9)": ("dft_mid_conv",),
    "ratio_kld_f32 (K4)": ("ratio_kld_f32",),
    "update_select_f32 (K5)": ("update_select_f32",),
    "conv2d_same (K11)": ("conv2d_same_mma_bf16",),
    "label_components_i16": ("label_components_i16",),
    "component_sums_f64": ("component_sums_f64",),
}


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, by its row name."""
    counts = kernel_counts()
    return {row: sum(counts.get(k, 0) for k in keys) for row, keys in KERNEL_ROWS.items()}


def smoke(pool, t_start: float) -> int:
    import torch

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
    from merfish3d_tpu_torch.utils import profiling

    profiling.enable()  # the launch counters count only with tracing on

    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 must be off")

    # -- 2. build; the chromatic inputs render meanwhile, so that the worker
    # competes with the build and the generators, not with the timed phases
    chromatic_future = pool.submit(chromatic_inputs)
    deformed_future = pool.submit(deformed_inputs)
    t_submit = time.perf_counter()
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
    kernels += check_component_kernels(raw)
    torch.cuda.empty_cache()
    kernels += check_dft_kernels(raw, torch.as_tensor(cam_fixed, device="cuda").to(torch.float32))
    torch.cuda.empty_cache()
    kernels += check_rlgc_kernels(raw)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        k11_row, k11_shapes = check_conv_kernel(raw, Path(tmp))
    kernels.append(k11_row)
    torch.cuda.empty_cache()

    # -- 4 + 5 + 6. the main path, counting launches
    reset_launch_counts()
    hermetic = [(*key, False, pin) for key, pin in HERMETIC_PINS.items()]
    hermetic += [(*key, True, pin) for key, pin in CNN_PINS.items()]
    hermetic_f1 = {}
    for dist_name, step, decon, cnn, pin in hermetic:
        t0 = time.perf_counter()
        res = hermetic_case(dist_name, step, decon, cnn)
        case = f"{dist_name}-{step}um-{'decon' if decon else 'nodecon'}{'-cnn' if cnn else ''}"
        hermetic_f1[case] = {"f1": res["f1"], "pin": pin}
        log(f"hermetic {case} on CUDA: F1 {res['f1']:.4f} "
            f"(pin {pin:.4f}, tp {res['true_positives']} fp {res['false_positives']} "
            f"fn {res['false_negatives']}), {time.perf_counter() - t0:.1f} s")
        require(abs(res["f1"] - pin) <= F1_TOLERANCE, f"{case} F1 off its pin")
        require(not cnn or res["f1"] >= HERMETIC_PINS[(dist_name, step, decon)] - F1_TOLERANCE,
                f"{case} F1 below the DoG pin")
    productions = {}
    for key, decon, cnn in (("nodecon", False, False), ("decon", True, False), ("nodecon-cnn", False, True)):
        prod = production_case(raw, decon=decon, cnn=cnn)
        productions[key] = prod
        torch.cuda.empty_cache()
        log(f"production geometry (1 tile (16, 1024, 1024) x 16 bits, 2400 spots, seed 21, round "
            f"shifts up to 2 px; "
            + (f"RLGC on the readout bits, {PRODUCTION_DECON_ITERS} iterations" if decon else "no decon")
            + ("; the c8 U-FISH CNN" if cnn else "; the DoG predictor")
            + f"; no deformation, no chromatic) on {card}:")
        log(f"  fiducial registration of 7 moving rounds {prod['fiducial_registration_s']:.3f} s "
            f"({prod['fiducial_registration_s_per_round']:.3f} s a round"
            + (f"; first run {prod['fiducial_registration_first_s']:.3f} s" if not decon else "")
            + f"); max round-shift residual {prod['max_round_shift_residual_px']:.3f} px (per round, "
            f"z y x: {prod['round_shift_residual_px']})")
        if decon:
            log(f"  decon of 16 bits {prod['decon_s']:.3f} s, iterations per bit "
                f"{prod['decon_iterations_per_bit']}, {prod['decon_ms_per_iteration_per_volume']:.2f} ms "
                f"an iteration and volume (paired solves)")
        log(f"  readout bits {prod['readout_bits_s']:.3f} s, of which the spot predictor "
            f"{prod['predictor_s']:.3f} s")
        log(f"  register_all_tiles (fiducials + readout bits {prod['readout_bits_s']:.3f} s) "
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
    require(len(productions["decon"]["decon_iterations_per_bit"]) == raw.bits.shape[1],
            "not every readout bit was deconvolved")
    fid = fiducial_decon_case(raw)
    torch.cuda.empty_cache()
    log(f"production geometry, fiducial rounds with RLGC ({PRODUCTION_DECON_ITERS} iterations) on {card}: "
        f"fiducial registration of 7 moving rounds {fid['fiducial_registration_s']:.3f} s, of which the "
        f"moving rounds' solves {fid['moving_decon_s']:.3f} s (iterations {fid['moving_decon_iterations']}); "
        f"max round-shift residual {fid['max_round_shift_residual_px']:.3f} px (per round, z y x: "
        f"{fid['round_shift_residual_px']}); peak device memory {fid['peak_device_bytes'] / 2**30:.2f} GiB")
    require(fid["max_round_shift_residual_px"] <= SHIFT_TOL_PX,
            "a production round shift was not recovered within 0.3 px with fiducial decon")
    with tempfile.TemporaryDirectory() as tmp:
        c32 = c32_tile_case(raw, Path(tmp))
    torch.cuda.empty_cache()
    log(f"c32 U-FISH (seeded weights, ConvTranspose decoder) on the production tile's "
        f"{c32['planes']} planes of 1024^2, no decon, on {card}: predictor {c32['predictor_s']:.3f} s "
        f"({c32['planes_per_s']:.1f} planes/s), readout-bit step {c32['readout_bits_s']:.3f} s, peak "
        f"device memory {c32['peak_device_bytes'] / 2**30:.2f} GiB (not decoded: random weights)")
    # the tile's convolutions: every batch runs the layers of phase 3
    batches = -(-c32["planes"] // 8)
    tflop = batches * sum(s["uses"] * s["gflop"] for s in k11_shapes) / 1e3
    tbytes = batches * sum(s["uses"] * s["gbytes"] for s in k11_shapes) / 1e3
    c32.update(conv_tflop=tflop, conv_tbytes=tbytes,
               k11_s=batches * sum(s["uses"] * s["ms"] for s in k11_shapes) / 1e3)
    log(f"  its convolutions: {tflop:.1f} TFLOP, {tbytes:.3f} TB of activations and weights; byte "
        f"bound {tbytes * 1e12 / HBM_BYTES_PER_S:.3f} s, bf16 tensor-rate bound "
        f"{tflop * 1e12 / BF16_TENSOR_FLOP_PER_S:.3f} s, FP32-core floor "
        f"{tflop * 1e12 / FP32_FLOP_PER_S:.3f} s; K11 at phase 3's times {c32['k11_s']:.3f} s")

    # -- 6. camera geometry pair
    camera = camera_case(cam_fixed, cam_moving)
    log(f"camera geometry pair (32, 2048, 2048), injected shift {CAMERA_SHIFT_PX} px: recovered "
        f"{camera['recovered_px']} px in {camera['seconds']:.3f} s (residual "
        f"{camera['residual_px']:.3f} px)")
    require(camera["residual_px"] <= SHIFT_TOL_PX, "the camera pair's shift was not recovered")

    launches = launch_counts()
    counts = kernel_counts()
    direct = counts.get("conv2d_same_f32", 0)
    log(f"launch counts on the main path: {launches}; K8's by route radix "
        f"{counts.get('dft_leading.radix', 0)}, z {counts.get('dft_leading.z', 0)}; "
        f"K11's FP32-core (f32-operand) kernel {direct}")
    require(all(n > 0 for n in launches.values()), "a kernel of the path never launched")
    require(direct == 0, "a U-Net convolution missed the tensor-core kernel")
    require(sorted(launches) == sorted(row["name"] for row in kernels), "a kernel has no row")

    # -- 7. each warp class on the card
    warps = warp_classes_case(raw)
    torch.cuda.empty_cache()
    for kind, w in warps.items():
        log(f"warp class {kind} over the production tile's 16 bits (16, 1024, 1024) on {card}: "
            f"{w['ms']:.3f} ms ({w['voxels_per_s']:.4g} voxels/s); two bits against the CPU port: "
            f"max |err| / max |x| {w['max_rel_err_vs_cpu']:.3e} (limit {WARP_RTOL})")

    # -- 8 + 9. the chromatic path, counting launches
    t0 = time.perf_counter()
    raw_chrom, beads = chromatic_future.result()
    log(f"chromatic inputs (numpy, a worker process, {time.perf_counter() - t_submit:.1f} s since submitted): "
        f"waited {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    chrom = chromatic_production_case(raw_chrom)
    chrom_store = chrom.pop("store")
    del raw_chrom
    torch.cuda.empty_cache()
    base_f1 = productions["nodecon"]["f1"]["f1"]
    log(f"production geometry with the injected chromatic aberration (translation "
        f"{INJECTED_TRANSLATION_UM} um, y/x scale {INJECTED_YX_SCALE}, second emission channel, at render "
        f"time; fiducial registration, DoG, no decon; decode with the chromatic estimate, 3 iterations) on "
        f"{card}: status {chrom['status']}, |translation error| {chrom['translation_error_um']} um, y/x scale "
        f"{chrom['yx_scale']}, used pairs {chrom['used_pairs']}")
    log(f"  decode stage {chrom['decode_s']:.2f} s, of which the decode warps {sum(chrom['warp_s']):.3f} s "
        f"({100 * chrom['warp_share']:.2f} %, {len(chrom['warp_s'])} warps of the 16-bit stack: "
        f"{[round(v, 4) for v in chrom['warp_s']]} s) and the chromatic estimates "
        f"{sum(chrom['estimate_s']):.3f} s ({100 * chrom['estimate_share']:.2f} %: "
        f"{[round(v, 4) for v in chrom['estimate_s']]} s); region statistics with the centroid sums "
        f"{sum(chrom['extract_s']):.3f} s ({100 * chrom['extract_share']:.2f} %: "
        f"{[round(v, 4) for v in chrom['extract_s']]} s)")
    log(f"  F1 {chrom['f1']['f1']:.4f} (tp {chrom['f1']['true_positives']} fp {chrom['f1']['false_positives']} "
        f"fn {chrom['f1']['false_negatives']}); without aberration (phase 5) {base_f1:.4f}")
    require(chrom["status"] == "affine_estimated", "the chromatic affine was not estimated")
    require(max(chrom["translation_error_um"]) <= CHROMATIC_TRANSLATION_TOL_UM,
            "the chromatic translation was not recovered")
    require(max(abs(v - INJECTED_YX_SCALE) for v in chrom["yx_scale"]) <= CHROMATIC_SCALE_TOL,
            "the chromatic scale was not recovered")
    require(chrom["f1"]["f1"] >= 0.5, "chromatic production F1 below 0.5")
    bead = bead_calibration_case(chrom_store, beads)
    del beads, chrom_store
    torch.cuda.empty_cache()
    log(f"bead calibration, 3 channels {BEAD_SHAPE} at {BEAD_WAVELENGTHS_UM} um (RLGC with vectorial PSFs, "
        f"then bead detection on the card) on {card}: {bead['calibration_s']:.3f} s, RLGC iterations "
        f"{bead['rlgc_iterations']} in {[round(v, 3) for v in bead['rlgc_s']]} s")
    for wl, ch in bead["channels"].items():
        log(f"  {wl} um: status {ch['status']}, pairs {ch['pairs']} (inliers {ch['inliers']}), |translation "
            f"error| {ch['translation_error_um']} um (limit {BEAD_TRANSLATION_TOL_UM}), max |linear error| "
            f"{ch['linear_error']:.5f} (limit {BEAD_LINEAR_TOL})")
        require(ch["status"] == "affine_estimated" and max(ch["translation_error_um"]) <= BEAD_TRANSLATION_TOL_UM
                and ch["linear_error"] <= BEAD_LINEAR_TOL, f"the {wl} um bead affine was not recovered")
    log(f"  0.67 um channel warped onto the reference with its calibration (general class, "
        f"{bead['general_warp_s']:.4f} s): beads {bead['beads_warped']} / reference {bead['beads_reference']}, "
        f"matched {bead['beads_matched']}, landing max {bead['landing_px_max']:.3f} px, median "
        f"{bead['landing_px_median']:.3f} px (limit {BEAD_LANDING_TOL_PX})")
    require(bead["beads_matched"] >= 0.9 * bead["beads_reference"]
            and bead["landing_px_max"] <= BEAD_LANDING_TOL_PX, "warped beads did not land on the reference's")
    chromatic_launches = launch_counts()
    log(f"launch counts on the chromatic path: {chromatic_launches}")
    require(all(chromatic_launches[k] > 0 for k in ("decode_chunk_f32 (K3)", "zy_lowpass_f32 (K1)",
                                                     "x_lowpass_decode_f32 (K2)", "ratio_kld_f32 (K4)",
                                                     "update_select_f32 (K5)", "label_components_i16",
                                                     "component_sums_f64"))
            and (min(chromatic_launches["dft_zx (K10)"], chromatic_launches["dft_mid_conv (K9)"]) > 0
                 or min(chromatic_launches[k] for k in ("dft_trailing (K6)", "dft_middle (K7)",
                                                        "dft_leading (K8)")) > 0),
            "a kernel of the chromatic path never launched")

    # -- 10. the deformed production tile, counting launches
    t0 = time.perf_counter()
    raw_def = deformed_future.result()
    log(f"deformed input (numpy, a worker process, {time.perf_counter() - t_submit:.1f} s since submitted): "
        f"waited {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    deformed = chromatic_production_case(raw_def, decon_readout=True, decon_max_iters=PRODUCTION_DECON_ITERS,
                                         deformable_registration=True)
    deformed_launches = launch_counts()
    deformed["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    def_store = deformed.pop("store")
    torch.cuda.empty_cache()
    residual = round_shift_residual_px(def_store, raw_def)
    flows = {r: def_store.flow_fields[(0, r)][1] for r in range(1, raw_def.fiducial.shape[1])}
    log(f"deformed production tile (deformation {DEFORMATION_PX} px, round shifts up to 2 px, the chromatic "
        f"injection; registration with RLGC on the readout bits ({PRODUCTION_DECON_ITERS} iterations) and "
        f"deformable flow (default SofimaRegistrationConfig); decode with the chromatic estimate, 3 iterations) "
        f"on {card}:")
    for (r, attrs), secs in zip(flows.items(), deformed["flow_s"]):
        log(f"  round {r}: flow {secs:.3f} s, status {attrs['sofima_status']}, valid vectors "
            f"{attrs['valid_flow_vectors']} / {LATTICE_SITES}")
    log(f"  register_all_tiles {deformed['register_s']:.3f} s, of which the flows {sum(deformed['flow_s']):.3f} s "
        f"(phase 5 with decon: {productions['decon']['register_s']:.3f} s); round-shift residual max "
        f"{float(residual.max()):.3f} px (the reference's two-tile deformed case: {REFERENCE_DEFORMED_RESIDUAL_PX} "
        f"px; not gated: the deformation shares the rigid part)")
    log(f"  chromatic status {deformed['status']}, |translation error| {deformed['translation_error_um']} um, "
        f"y/x scale {deformed['yx_scale']}")
    log(f"  decode stage {deformed['decode_s']:.2f} s, of which the decode warps {sum(deformed['warp_s']):.3f} s "
        f"({100 * deformed['warp_share']:.2f} %) and their flow batches {sum(deformed['flow_warp_s']):.3f} s "
        f"({100 * deformed['flow_warp_share']:.2f} %: {[round(v, 4) for v in deformed['flow_warp_s']]} s), the "
        f"chromatic estimates {sum(deformed['estimate_s']):.3f} s ({100 * deformed['estimate_share']:.2f} %)")
    log(f"  F1 {deformed['f1']['f1']:.4f} (tp {deformed['f1']['true_positives']} fp "
        f"{deformed['f1']['false_positives']} fn {deformed['f1']['false_negatives']}); chromatic tile without "
        f"deformation (phase 8) {chrom['f1']['f1']:.4f}; peak device memory "
        f"{deformed['peak_device_bytes'] / 2**30:.2f} GiB")
    log(f"launch counts on the deformed path: {deformed_launches}")
    require(all(a["sofima_status"] == "ok" for a in flows.values()), "a round's flow found no valid vector")
    require(deformed["status"] == "affine_estimated"
            and max(deformed["translation_error_um"]) <= CHROMATIC_TRANSLATION_TOL_UM,
            "the chromatic affine was not recovered on the deformed tile")
    require(deformed["f1"]["f1"] >= 0.5, "deformed production F1 below 0.5")
    require(all(deformed_launches[k] > 0 for k in (
        "zy_lowpass_f32 (K1)", "x_lowpass_decode_f32 (K2)", "decode_chunk_f32 (K3)", "ratio_kld_f32 (K4)",
        "update_select_f32 (K5)", "dft_middle (K7)", "dft_mid_conv (K9)", "dft_zx (K10)",
        "label_components_i16", "component_sums_f64")),
        "a kernel of the deformed path never launched")
    landing = bead_landing_case(def_store, raw_def)
    for r, row in landing["rounds"].items():
        log(f"  round {r} bead landing on round 0 ({landing['beads']} beads, max |delta| over the axes): affine "
            f"alone median {row['affine']['median_px']:.3f} px, p95 {row['affine']['p95_px']:.3f}; affine + flow "
            f"median {row['flow']['median_px']:.3f} px, p95 {row['flow']['p95_px']:.3f}")
    require(all(row["flow"]["median_px"] < row["affine"]["median_px"] for row in landing["rounds"].values()),
            "the flow did not bring a round's beads closer than its affine alone")
    versus = flow_card_vs_cpu(def_store, round_idx=1)
    log(f"  round 1 flow, card {versus['card_s']:.3f} s against the CPU port {versus['cpu_s']:.3f} s: valid "
        f"{versus['valid_card']} / {versus['valid_cpu']}, split {versus['split_sites']} (away from a gate "
        f"{versus['split_away_from_gate']}); ratio, sharpness max rel {versus['ratio_max_rel']:.2e}, "
        f"{versus['sharpness_max_rel']:.2e}; first pass max |delta| {versus['first_pass_max_px']:.2e} px, field "
        f"{versus['field_max_px']:.2e} px (limit {FLOW_CPU_TOL_PX}); flow batch warp of bits "
        f"{versus['warp_bits']} ({'separable' if versus['warp_separable'] else 'gather'}) max |err| / max |x| "
        f"{versus['warp_max_rel_err']:.3e} (limit {WARP_RTOL})")
    require(versus["split_away_from_gate"] == 0 and versus["meta_equal"]
            and max(versus["first_pass_max_px"], versus["field_max_px"]) <= FLOW_CPU_TOL_PX,
            "the card's flow field disagrees with the CPU port's")
    require(versus["warp_max_rel_err"] <= WARP_RTOL, "the card's flow warp disagrees with the CPU port's")
    del def_store, raw_def
    torch.cuda.empty_cache()

    # one production bit through the kernels and through the plain versions
    twice = solve_twice(raw)
    log(f"production bit 0 solved twice from seed 7: iterations {twice['iterations_kernels']} "
        f"(kernels, {twice['seconds_kernels']:.3f} s) and {twice['iterations_plain']} (plain "
        f"versions, {twice['seconds_plain']:.3f} s); max |delta| / max |recon| "
        f"{twice['max_rel_delta']:.3e} (limit {SOLVE_MAX_RTOL}), ||delta|| / ||recon|| "
        f"{twice['l2_rel_delta']:.3e} (limit {SOLVE_L2_RTOL})")
    require(twice["iterations_kernels"] == twice["iterations_plain"]
            and twice["max_rel_delta"] <= SOLVE_MAX_RTOL and twice["l2_rel_delta"] <= SOLVE_L2_RTOL,
            "the kernel and plain solves disagree")

    # one camera frame through the kernels and through the plain versions
    frame = torch.as_tensor(cam_fixed, device="cuda").to(torch.float32)
    del cam_fixed, cam_moving
    readout_psf = production_psf(raw)
    cam_solve = camera_frame_solve(frame, readout_psf)
    ck, cp = cam_solve["kernels"], cam_solve["plain"]
    log(f"camera frame (32, 2048, 2048) deconvolved in one tile (padded (48, 2176, 2176): K6, K7, K8) "
        f"from seed 7 on {card}: iterations {ck['iterations']} (kernels, {ck['seconds']:.3f} s, peak "
        f"{ck['peak_device_bytes'] / 2**30:.2f} GiB) and {cp['iterations']} (plain versions, "
        f"{cp['seconds']:.3f} s, peak {cp['peak_device_bytes'] / 2**30:.2f} GiB); max |delta| / max |recon| "
        f"{cam_solve['max_rel_delta']:.3e} (limit {CAMERA_SOLVE_MAX_RTOL}), ||delta|| / ||recon|| "
        f"{cam_solve['l2_rel_delta']:.3e} (limit {CAMERA_SOLVE_L2_RTOL})")
    require(ck["iterations"] == cp["iterations"] and cam_solve["max_rel_delta"] <= CAMERA_SOLVE_MAX_RTOL
            and cam_solve["l2_rel_delta"] <= CAMERA_SOLVE_L2_RTOL,
            "the camera frame's kernel and plain solves disagree")
    torch.cuda.empty_cache()
    check_camera_frame_dft(frame, readout_psf)
    torch.cuda.empty_cache()

    # the same frame tiled at chunked_rlgc's default crop
    tiled = camera_frame_tiled(frame, readout_psf)
    del frame
    torch.cuda.empty_cache()
    tk, tp = tiled["kernels"], tiled["plain"]
    log(f"camera frame (32, 2048, 2048) tiled at the default crop {tiled['crop_yx']} (halo "
        f"{tiled['halo_yx']}, seams y {tiled['seams_y']} x {tiled['seams_x']}) from seed 7 on {card}: "
        f"kernels {tk['seconds']:.3f} s (peak {tk['peak_device_bytes'] / 2**30:.2f} GiB), plain versions "
        f"{tp['seconds']:.3f} s (peak {tp['peak_device_bytes'] / 2**30:.2f} GiB)")
    for i, (ret, a, b) in enumerate(zip(tiled["retained"], tk["tiles"], tp["tiles"])):
        log(f"  tile {i} retained {ret}, padded {a['padded_shape']}: iterations {a['iterations']} "
            f"(kernels, {a['seconds']:.3f} s) and {b['iterations']} (plain, {b['seconds']:.3f} s); "
            f"kernel launches {a['launches']}")
    log(f"  whole frame: max |delta| / max |recon| {tiled['max_rel_delta']:.3e}, ||delta|| / ||recon|| "
        f"{tiled['l2_rel_delta']:.3e}; +-halo band of the seams: {tiled['seam_max_rel_delta']:.3e}, "
        f"{tiled['seam_l2_rel_delta']:.3e} (limits {CAMERA_SOLVE_MAX_RTOL}, {CAMERA_SOLVE_L2_RTOL})")
    require(tk["iterations"] == tp["iterations"], "a tile's kernel and plain solves stopped apart")
    require(max(tiled["max_rel_delta"], tiled["seam_max_rel_delta"]) <= CAMERA_SOLVE_MAX_RTOL
            and max(tiled["l2_rel_delta"], tiled["seam_l2_rel_delta"]) <= CAMERA_SOLVE_L2_RTOL,
            "the tiled camera frame's kernel and plain solves disagree")

    for row in kernels:
        row["launches"] = launches[row["name"]]
    summary = {"hermetic_f1": hermetic_f1, "production": {}, "fiducial_decon": fid, "c32_tile": c32,
               "k11_layers": k11_shapes, "camera_pair": camera, "solve_twice": twice,
               "camera_frame_solve": cam_solve, "camera_frame_tiled": tiled, "dft_times": DFT_TIMES,
               "warp_classes": warps, "chromatic_production": {**chrom, "f1": chrom["f1"]["f1"]},
               "bead_calibration": bead, "chromatic_launches": chromatic_launches,
               "deformed_production": {**deformed, "f1": deformed["f1"]["f1"],
                                       "round_shift_residual_px": residual.round(4).tolist(),
                                       "flows": flows, "bead_landing": landing, "card_vs_cpu": versus},
               "deformed_launches": deformed_launches}
    for key, prod in productions.items():
        summary["production"][key] = {k: v for k, v in prod.items() if k != "f1"}
        summary["production"][key]["f1"] = prod["f1"]["f1"]
    summary["smoke_s"] = time.perf_counter() - t_start
    log(json.dumps(summary))
    log(f"smoke wall {summary['smoke_s']:.1f} s, kernel build included")
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
