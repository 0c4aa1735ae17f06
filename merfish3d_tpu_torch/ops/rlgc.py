"""Richardson-Lucy Gradient-Consensus (RLGC) deconvolution (counterpart of
``merfish3d_tpu/ops/rlgc.py``).

Each iteration of a solve, on the symmetrically padded volume:

1. a 50:50 binomial split of the observed photon counts (:func:`binomial_half`);
2. the forward model ``Hu = conv(recon, otf)`` (:func:`.fftutils.fft_conv_full`);
3. both update ratios and both split KLDs in one pass (K4, :func:`.rlgc_kernels.ratio_kld`);
4. the adjoint convolution of the two ratios packed as one complex pair,
   the consensus convolution of ``(ht1 - 1)·(ht2 - 1)``;
5. the consensus-gated update, the branchless restore select and the
   convergence statistics in one pass (K5, :func:`.rlgc_kernels.update_select`),
   then the boundary re-symmetrization.

Where the shape takes them, the convolutions are K10 forward → K9 → K10
inverse (:func:`.fftutils.fft_conv_spec`). The math is the reference's,
including its ``MIN_STOP_ITERS`` floor on the restore and convergence
exits. In PyTorch's idiom:

- the reference's ``while_loop`` is a host loop making one small
  device→host read an iteration (both KLDs, the restore flag and K5's
  three statistics) for the stop decision; the restore flag itself is
  computed on the device, so K5 does not wait for the host;
- every solve, of one volume (:func:`rlgc`) or many (:func:`rlgc_batch`),
  runs one retire-and-reload loop: two volumes at a time with every
  convolution packed as one complex pair (the reference's default
  pairing), a converged slot retired and reloaded with the next volume on
  the host; a single volume takes one slot;
- the splits come from a ``torch.Generator`` on the volume's device,
  seeded from (volume seed, iteration): JAX's threefry bits cannot be
  reproduced, so a solve is held to the reference statistically, or with
  the reference's own splits injected through ``split_fn``.

The reference's bf16-spectrum mode (off by default there) is not ported:
every spectrum is float32.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import profiling
from .device import as_device_tensor
from .fftutils import (
    axis_linear_fft_padding,
    c_conj,
    c_mul,
    enforce_symmetric_boundary,
    fft_conv_full,
    fft_conv_spec,
    fftn_spec,
    linear_fft_pad_width,
    observed_region_mask,
    pad_psf,
    pad_symmetric,
    remove_padding_zyx,
)
from .rlgc_kernels import kl_div_plain, ratio_kld, update_select

# The split-KLD rule compares KLDs under different random splits; on dim,
# spot-sparse volumes the split variance exceeds the early improvement, so
# the restore and the convergence exits wait this many iterations (the
# reference's constant and reasoning, ``rlgc.py:175-187``).
MIN_STOP_ITERS = 3

# The reference's batch and crop budgets, kept so the port makes the same
# batch and crop choices (set there for a 16 GB v5e).
DEFAULT_BUDGET_PADDED_VOXELS = 9.0e7
SCAN_TOTAL_F32_BUDGET = 2.2e9
_PAIR_WORKING_SET_BUFFERS = 16.0
MAX_SCAN_BATCH = 32

# split_fn(observed padded volume, volume seed, iteration) -> split1
SplitFn = Callable[[torch.Tensor, int, int], torch.Tensor]


# -------------------------------------------------------------- splitting
def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of 32-bit values held in int64 (torch has no
    popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def binomial_half(gen: torch.Generator, counts: torch.Tensor) -> torch.Tensor:
    """Binomial(n, 1/2) draws for photon-count splitting, the reference's
    sampler: exact for n <= 32 (the popcount of n masked uniform random
    bits), a rounded, clipped normal (mean n/2, variance n/4) beyond."""
    n = counts.to(torch.int64)
    dev = n.device
    bits = torch.randint(0, 2**32, n.shape, generator=gen, device=dev, dtype=torch.int64)
    mask = (torch.ones_like(n) << n.clamp(0, 32)) - 1
    exact = _popcount32(bits & mask).to(torch.float32)
    nf = n.to(torch.float32)
    z = torch.randn(n.shape, generator=gen, device=dev, dtype=torch.float32)
    approx = torch.minimum(torch.round(0.5 * nf + torch.sqrt(0.25 * nf) * z).clamp(min=0.0), nf)
    return torch.where(n <= 32, exact, approx)


def split_seed(seed: int, iteration: int) -> int:
    """The generator seed of one volume's split at one iteration."""
    return int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1, np.uint64)[0])


def binomial_split(observed: torch.Tensor, seed: int, iteration: int) -> torch.Tensor:
    """The default ``split_fn``: split1 of one iteration, drawn on the
    volume's device."""
    gen = torch.Generator(device=observed.device)
    gen.manual_seed(split_seed(seed, iteration))
    return binomial_half(gen, observed)


# ------------------------------------------------------------ solve state
@dataclass
class _Solve:
    """Per-solve constants: the observed-region mask, the interior voxel
    count, the forward, adjoint and consensus OTF pairs and the clamped
    Hᵀ·mask normalization (reference ``_prepare_solve``)."""

    mask: torch.Tensor
    num_pixels: float
    otf: tuple
    otf_t: tuple
    otf2: tuple
    update_norm: torch.Tensor


def _prepare_solve(shape, psf, pad_width, device) -> _Solve:
    mask = observed_region_mask(shape, pad_width, device=device)
    num_pixels = float(np.prod([s - b - a for s, (b, a) in zip(shape, pad_width)]))
    otf = fftn_spec(profiling.to_device(pad_psf(psf, shape), device))
    otf_t = c_conj(otf)
    otf2 = c_mul(otf, otf_t)
    update_norm = torch.clamp(fft_conv_full(mask, otf_t), min=1e-6)
    return _Solve(mask, num_pixels, otf, otf_t, otf2, update_norm)


@dataclass
class _Slot:
    """One volume's carry: recon, previous recon, previous KLDs, iteration
    count, done flag."""

    vol: int
    observed: torch.Tensor
    recon: torch.Tensor
    prev: torch.Tensor
    prev_kld: tuple = (float("inf"), float("inf"))
    it: int = 0
    done: bool = False


def _load(vol: int, observed: torch.Tensor, solve: _Solve) -> _Slot:
    """A fresh slot, initialized to the volume's flat interior mean."""
    mean = torch.sum(observed * solve.mask) / solve.num_pixels
    init = mean.expand(observed.shape).contiguous()
    return _Slot(vol, observed, init, init)


def _split_ht(gr, gi, update_norm):
    """ht := 1 (the no-op update) where the adjoint has no mask support:
    deep in the padding update_norm decays to its clamp and g/norm is
    rounding error amplified up to 1e6 (reference ``_split_ht``)."""
    ok = update_norm >= 1e-3
    return torch.where(ok, gr / update_norm, 1.0), torch.where(ok, gi / update_norm, 1.0)


def _restore_flag(kld1, kld2, slot: _Slot, safe_mode: bool) -> torch.Tensor:
    """Restore the previous recon when a split KLD rose (either in safe
    mode, both otherwise), from the minimum iteration on; computed on the
    device."""
    if slot.it < MIN_STOP_ITERS:
        return torch.zeros((), dtype=torch.bool, device=kld1.device)
    rose1, rose2 = kld1 > slot.prev_kld[0], kld2 > slot.prev_kld[1]
    return (rose1 | rose2) if safe_mode else (rose1 & rose2)


def _update(consensus, slot: _Slot, ht, restore, klds, pad_width):
    """K5, the boundary rewrite, and the iteration's record for the host:
    (new recon, new prev, float64 [kld1, kld2, restore, num_updated,
    max_new, max_abs_delta] on the device)."""
    new_recon, new_prev, num_updated, max_new, max_abs_delta = update_select(
        consensus, slot.recon, slot.prev, ht, restore, pad_width
    )
    # the rewrite commutes with the restore select, and prev already
    # satisfies it
    new_recon = enforce_symmetric_boundary(new_recon, pad_width)
    record = torch.stack([
        t.to(torch.float64) for t in (*klds, restore, num_updated, max_new, max_abs_delta)
    ])
    return new_recon, new_prev, record


def _advance(slot: _Slot, new_recon, new_prev, record, num_pixels, limit, max_delta) -> None:
    """The host half of an iteration: take the step, count it unless it
    restored, and decide whether the volume is done."""
    kld1, kld2, restore, num_updated, max_new, max_abs_delta = record
    slot.recon, slot.prev = new_recon, new_prev
    if restore:
        slot.done = True
        return
    converged = (
        num_updated / num_pixels < limit or max_abs_delta / max(max_new, 1e-12) < max_delta
    ) and slot.it + 1 >= MIN_STOP_ITERS
    slot.prev_kld = (kld1, kld2)
    slot.it += 1
    slot.done = converged


def _ratios_and_restore(slot: _Slot, hu, split_fn: SplitFn, seed: int, pad_width, safe_mode):
    split1 = split_fn(slot.observed, seed, slot.it)
    split2 = slot.observed - split1
    r1, r2, klds = ratio_kld(hu, split1, split2, pad_width)
    return r1, r2, klds, _restore_flag(*klds, slot, safe_mode)


def _conv_pair(a, b, otf):
    """Convolve two real volumes with one packed complex convolution (the
    pack is exact: conv(a + ib, k) = conv(a, k) + i·conv(b, k) for a real
    kernel); either may be None."""
    if a is None:
        return None, fft_conv_full(b, otf)
    if b is None:
        return fft_conv_full(a, otf), None
    return fft_conv_spec(a, b, otf)


def _rlgc_queue_core(
    images: torch.Tensor,
    psf: np.ndarray,
    seeds,
    retire: Callable[[int, torch.Tensor, int], None],
    *,
    pad_width,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    split_fn: Optional[SplitFn] = None,
) -> None:
    """RLGC solve of a batch of unpadded volumes (shared PSF), two slots at
    a time with every convolution packed as a complex pair (per iteration
    the forward pair, one adjoint pair a slot and the consensus pair, where
    two single solves would run six convolutions). A converged (or capped)
    slot retires, ``retire(volume, padded recon, iterations)``, and reloads
    the next queued volume, so unequal iteration counts cost nothing. A
    batch of one runs one slot, whose pairs are single convolutions."""
    split_fn = split_fn or binomial_split
    n_vol = images.shape[0]
    padded_shape = tuple(n + b + a for n, (b, a) in zip(images.shape[1:], pad_width))
    solve = _prepare_solve(padded_shape, psf, pad_width, images.device)

    def load(v: int) -> _Slot:
        return _load(v, pad_symmetric(images[v].to(torch.float32), pad_width), solve)

    queued = min(2, n_vol)
    slots: list = [load(v) for v in range(queued)] + [None] * (2 - queued)

    def retire_done() -> None:
        nonlocal queued
        for i, slot in enumerate(slots):
            while slot is not None and (slot.done or slot.it >= max_iters):
                retire(slot.vol, slot.recon, slot.it)
                slot = slots[i] = load(queued) if queued < n_vol else None
                queued += 1

    retire_done()  # a volume with no iteration to take retires as it loads
    while any(s is not None for s in slots):
        with profiling.span("rlgc.step"):
            hus = _conv_pair(*[None if s is None else s.recon for s in slots], solve.otf)
            per_slot = []
            for slot, hu in zip(slots, hus):
                if slot is None:
                    per_slot.append(None)
                    continue
                r1, r2, klds, restore = _ratios_and_restore(
                    slot, hu, split_fn, seeds[slot.vol], pad_width, safe_mode
                )
                gr, gi = fft_conv_spec(r1, r2, solve.otf_t)
                del r1, r2
                ht1, ht2 = _split_ht(gr, gi, solve.update_norm)
                per_slot.append((ht1 + ht2, (ht1 - 1.0) * (ht2 - 1.0), restore, klds))
            del hus
            cons = _conv_pair(*[None if p is None else p[1] for p in per_slot], solve.otf2)
            steps, records = [], []
            for slot, p, consensus in zip(slots, per_slot, cons):
                if slot is None:
                    continue
                new_recon, new_prev, record = _update(consensus, slot, p[0], p[2], p[3], pad_width)
                steps.append((slot, new_recon, new_prev))
                records.append(record)
            del per_slot, cons
            with profiling.span("rlgc.read"):
                values = profiling.read_list(torch.stack(records))
            for (slot, new_recon, new_prev), record in zip(steps, values):
                _advance(slot, new_recon, new_prev, record, solve.num_pixels, limit, max_delta)
            retire_done()


# ------------------------------------------------------------ entry points
def _as_psf(psf) -> np.ndarray:
    psf = np.asarray(psf, dtype=np.float32)
    return psf[None] if psf.ndim == 2 else psf


def _result(t: torch.Tensor, out: str):
    if out == "device":
        return t
    if out == "host":
        return profiling.to_host(t)
    raise ValueError(f"out must be 'host' or 'device', got {out!r}")


def rlgc(
    image,
    psf,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    pad_yx: bool = True,
    device=None,
    out: str = "host",
    split_fn: Optional[SplitFn] = None,
    return_iters: bool = False,
):
    """RLGC-deconvolve one 3D volume; float32 of the input shape, host
    numpy (``out="host"``) or a tensor on the device (``"device"``).
    ``device`` defaults to a tensor's own, and to ``cuda`` for a host
    array. ``split_fn(observed, seed, iteration)`` replaces the binomial
    split (a test injects the reference's splits through it).
    ``return_iters`` also returns the solve's iteration count."""
    with profiling.span("rlgc.solve"):
        img = as_device_tensor(image, device).to(torch.float32)
        psf = _as_psf(psf)
        pad_width = linear_fft_pad_width(tuple(img.shape), psf.shape, pad_yx=pad_yx)
        solved = []

        def retire(_vol, recon, n):
            solved.append((remove_padding_zyx(recon, pad_width).contiguous(), n))

        _rlgc_queue_core(
            img[None], psf, [seed], retire, pad_width=pad_width, safe_mode=safe_mode,
            limit=limit, max_delta=max_delta, max_iters=max_iters, split_fn=split_fn,
        )
        (recon, iters), = solved
        result = _result(recon, out)
    return (result, iters) if return_iters else result


def rlgc_batch(
    images,
    psf,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    out: str = "host",
    device=None,
    split_fn: Optional[SplitFn] = None,
    return_iters: bool = False,
):
    """Deconvolve a batch of same-shaped volumes (e.g. the readout bits of
    a tile that share a PSF) in the paired retire-and-reload solve, the
    reference's default; volume i is seeded ``seed + i``. Integer data
    (u16) uploads as it is and is cast on the device. ``return_iters``
    also returns the iteration count of each volume."""
    with profiling.span("rlgc.solve"):
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        stack = as_device_tensor(images, device)
        psf = _as_psf(psf)
        pad_width = linear_fft_pad_width(tuple(stack.shape[1:]), psf.shape)
        result = torch.empty(stack.shape, dtype=torch.float32, device=stack.device)
        iters = [0] * stack.shape[0]

        def retire(vol, recon, n):
            result[vol] = remove_padding_zyx(recon, pad_width)
            iters[vol] = n

        _rlgc_queue_core(
            stack, psf, [seed + i for i in range(stack.shape[0])], retire, pad_width=pad_width,
            safe_mode=safe_mode, limit=limit, max_delta=max_delta, max_iters=max_iters,
            split_fn=split_fn,
        )
        result = _result(result, out)
    return (result, iters) if return_iters else result


def rlgc_diagnostics(
    image,
    psf,
    *,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    logger=None,
    device=None,
    split_fn: Optional[SplitFn] = None,
) -> np.ndarray:
    """RLGC with per-iteration structured log records (iteration, KLDs,
    update min/max, updated fraction, stop reason), as the reference's
    diagnostics channel: its stopping rule, which has no
    ``MIN_STOP_ITERS`` floor, and host reads every iteration."""
    log = logger or logging.getLogger("merfish3d_tpu_torch.rlgc")
    split_fn = split_fn or binomial_split
    img = as_device_tensor(image, device).to(torch.float32)
    psf = _as_psf(psf)
    pad_width = linear_fft_pad_width(tuple(img.shape), psf.shape)
    padded = pad_symmetric(img, pad_width)
    solve = _prepare_solve(padded.shape, psf, pad_width, padded.device)
    slot = _load(0, padded, solve)
    prev_kld1 = prev_kld2 = float("inf")
    for it in range(max_iters):
        split1 = split_fn(padded, seed, it)
        hu = fft_conv_full(slot.recon, solve.otf)
        r1, r2, klds = ratio_kld(hu, split1, padded - split1, pad_width)
        kld1, kld2 = (float(k) for k in klds)
        rose1, rose2 = kld1 > prev_kld1, kld2 > prev_kld2
        if (rose1 or rose2) if safe_mode else (rose1 and rose2):
            log.info(
                "stop=restore_previous_recon best_iteration=%d kld_split1=%.6f "
                "prev_kld_split1=%.6f kld_split2=%.6f prev_kld_split2=%.6f",
                max(it - 1, 0), kld1, prev_kld1, kld2, prev_kld2,
            )
            slot.recon = slot.prev
            break
        gr, gi = fft_conv_spec(r1, r2, solve.otf_t)
        ht1, ht2 = _split_ht(gr, gi, solve.update_norm)
        ht = ht1 + ht2
        consensus = fft_conv_full((ht1 - 1.0) * (ht2 - 1.0), solve.otf2)
        new_recon, _, num_updated, max_new, max_abs_delta = update_select(
            consensus, slot.recon, slot.prev, ht, False, pad_width
        )
        slot.prev, slot.recon = slot.recon, enforce_symmetric_boundary(new_recon, pad_width)
        prev_kld1, prev_kld2 = kld1, kld2
        frac = float(num_updated) / solve.num_pixels
        max_rel = float(max_abs_delta) / max(float(max_new), 1e-12)
        log.info(
            "iteration=%03d kld_split1=%.6f kld_split2=%.6f update_min=%.3f "
            "update_max=%.3f updated_fraction=%.5f max_relative_delta=%.5f",
            it + 1, kld1, kld2, float(ht.min()), float(ht.max()), frac, max_rel,
        )
        if frac < limit:
            log.info("stop=limit iteration=%03d updated_fraction=%.5f", it + 1, frac)
            break
        if max_rel < max_delta:
            log.info("stop=max_delta iteration=%03d max_relative_delta=%.5f", it + 1, max_rel)
            break
    return remove_padding_zyx(slot.recon, pad_width).cpu().numpy()


# ---------------------------------------------------------------- budgets
def max_vmap_batch(image_shape, psf_shape, budget_padded_voxels: Optional[float] = None) -> int:
    """How many volumes of this shape one :func:`rlgc_batch` call takes
    (the reference's budget arithmetic for its paired solve;
    ``budget_padded_voxels`` keeps its legacy total-padded-voxel form)."""
    padded = 1
    for n, s in zip(image_shape, psf_shape):
        padded *= int(n) + sum(axis_linear_fft_padding(int(n), s))
    if budget_padded_voxels is not None:
        return max(1, int(budget_padded_voxels // padded))
    b = int((SCAN_TOTAL_F32_BUDGET / padded - _PAIR_WORKING_SET_BUFFERS) // 2.0)
    return max(1, min(b, MAX_SCAN_BATCH))


def auto_crop_yx(image_shape, psf_shape, budget_padded_voxels: float = DEFAULT_BUDGET_PADDED_VOXELS) -> int:
    """Largest lateral crop whose padded solve, halo included, fits the
    budget (the reference's static replacement for an OOM-retry shrink)."""
    nz = int(image_shape[0])
    pz = nz + sum(axis_linear_fft_padding(nz, psf_shape[0]))
    halo_y, halo_x = 2 * int(psf_shape[1]), 2 * int(psf_shape[2])
    for crop in (4096, 3072, 2048, 1536, 1280, 1024, 768, 512, 384, 256):
        ey, ex = crop + halo_y, crop + halo_x
        py = ey + sum(axis_linear_fft_padding(ey, psf_shape[1]))
        px = ex + sum(axis_linear_fft_padding(ex, psf_shape[2]))
        if pz * py * px <= budget_padded_voxels:
            return crop
    return 256


def _axis_retained_bounds(length: int, crop: int) -> list[tuple[int, int]]:
    """Non-overlapping retained tile bounds exactly covering [0, length)."""
    if length <= crop:
        return [(0, length)]
    n = int(np.ceil(length / crop))
    edges = np.linspace(0, length, n + 1).round().astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n)]


def chunk_tiles(ny: int, nx: int, crop_yx: int, halo_y: int, halo_x: int):
    """The lateral tiles of :func:`chunked_rlgc`, in its seed order: a list
    of (retained (y0, y1, x0, x1), solved (ys, ye, xs, xe)); the solved
    extent is the retained one grown by the halo and clipped to the
    image."""
    tiles = []
    for y0, y1 in _axis_retained_bounds(ny, crop_yx):
        for x0, x1 in _axis_retained_bounds(nx, crop_yx):
            solved = (max(0, y0 - halo_y), min(ny, y1 + halo_y), max(0, x0 - halo_x), min(nx, x1 + halo_x))
            tiles.append(((y0, y1, x0, x1), solved))
    return tiles


def chunked_rlgc(
    image,
    psf,
    *,
    crop_yx: Optional[int] = None,
    seed: int = 42,
    safe_mode: bool = True,
    limit: float = 0.01,
    max_delta: float = 0.001,
    max_iters: int = 100,
    device=None,
    out: str = "host",
    split_fn: Optional[SplitFn] = None,
):
    """Lateral-tiled RLGC: retained (non-overlapping) YX tiles of at most
    ``crop_yx`` cover the image, each solved with a discarded halo of the
    PSF's full support and seed ``seed + tile index``
    (:func:`chunk_tiles`); ``crop_yx=None`` takes :func:`auto_crop_yx`.
    An image within one tile is one :func:`rlgc` solve. ``split_fn`` is
    passed to each tile's solve, with that tile's seed."""
    img = as_device_tensor(image, device).to(torch.float32)
    psf = _as_psf(psf)
    nz, ny, nx = img.shape
    if crop_yx is None:
        crop_yx = auto_crop_yx(img.shape, psf.shape)
    kw = dict(safe_mode=safe_mode, limit=limit, max_delta=max_delta, max_iters=max_iters, out="device",
              split_fn=split_fn)
    if ny <= crop_yx and nx <= crop_yx:
        return _result(rlgc(img, psf, seed=seed, **kw), out)
    result = torch.empty_like(img)
    for tile_idx, ((y0, y1, x0, x1), (ys, ye, xs, xe)) in enumerate(
        chunk_tiles(ny, nx, crop_yx, int(psf.shape[1]), int(psf.shape[2]))
    ):
        dec = rlgc(img[:, ys:ye, xs:xe], psf, seed=seed + tile_idx, **kw)
        result[:, y0:y1, x0:x1] = dec[:, y0 - ys: y1 - ys, x0 - xs: x1 - xs]
    return _result(result, out)


# ------------------------------------------------- reference-named helpers
def kl_div(p, q, mask=None) -> float:
    """Masked KL divergence (reference ``kl_div``)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32, device=p.device)
    mask = torch.ones_like(p) if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=p.device)
    return float(kl_div_plain(p, q, mask))


def pad_for_linear_fft(image, psf_shape, pad_yx: bool = True):
    """Pad a 3D image for a linear FFT convolution; returns (padded,
    pad_width)."""
    image = torch.as_tensor(image)
    pad_width = linear_fft_pad_width(tuple(image.shape), tuple(psf_shape), pad_yx)
    return pad_symmetric(image, pad_width), pad_width
