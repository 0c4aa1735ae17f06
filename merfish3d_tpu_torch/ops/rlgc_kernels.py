"""Fused elementwise passes of the RLGC iteration (counterpart of
``merfish3d_tpu/ops/rlgc_kernels.py``).

Two kernels, hand-written CUDA in ``csrc/rlgc.cu``:

- K4 :func:`ratio_kld` — both update ratios ``mask·split/(0.5·(Hu+1e-12))``
  and the six partial sums of both split KLDs (Σp, Σq₁, Σq₂, Σ'p, Σ't₁,
  Σ't₂), from which the KLDs are assembled as the reference does:
  with P = p/Σp and Q = q/Σq,
  Σ' P (log P − log Q) = Σ't/Σp − log(Σp/Σq) · Σ'p/Σp, where Σ' runs over
  the entries in the mask with p > 0;
- K5 :func:`update_select` — the consensus-gated update
  ``where(c < 0, rec, rec·ht)``, the restore select, and the convergence
  statistics (updated count, max new, max |Δ|) in the mask.

Each entry point launches its kernel on a CUDA tensor of a shape the
reference's gate (:func:`fused_elementwise_supported`) takes, and runs
its plain version — the reference's generic chain (``rlgc.py:152-157``
and ``:229-244``) — on any other tensor. The kernels fold their
reductions into per-block partial rows, which are folded here in FP64 (K4)
and as integers (K5's count): no float atomics, so a solve on the card
repeats exactly.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import count
from .fftutils import observed_region_mask

_LANE = 128
_EPS_KLD = 1e-4
_MAX_BLOCKS = 2048

def fused_elementwise_supported(shape) -> bool:
    """Shape gate of the flat (rows, nx) view both kernels use."""
    if len(shape) != 3:
        return False
    nz, ny, nx = (int(v) for v in shape)
    return nx % _LANE == 0 and (nz * ny) % 8 == 0


# --------------------------------------------------------- plain versions
def kl_div_plain(p, q, mask):
    """Masked KLD with eps smoothing (reference ``rlgc._kl_div``)."""
    p = (p + _EPS_KLD) * mask
    q = (q + _EPS_KLD) * mask
    p = p / torch.sum(p)
    q = q / torch.sum(q)
    kld = p * (torch.log(p) - torch.log(q))
    return torch.sum(torch.where(torch.isnan(kld), torch.zeros_like(kld), kld))


def ratio_kld_plain(hu, split1, split2, pad_width):
    """K4's plain version, the reference's generic chain."""
    mask = observed_region_mask(hu.shape, pad_width, device=hu.device)
    kld1 = kl_div_plain(hu, split1, mask)
    kld2 = kl_div_plain(hu, split2, mask)
    denom = 0.5 * (hu + 1e-12)
    return mask * (split1 / denom), mask * (split2 / denom), (kld1, kld2)


def update_select_plain(consensus, recon, prev_recon, ht, should_restore, pad_width):
    """K5's plain version, the reference's generic chain."""
    mask = observed_region_mask(consensus.shape, pad_width, device=consensus.device)
    updated = torch.where(consensus < 0, recon, recon * ht)
    num_updated = torch.sum((consensus >= 0) & (mask > 0))
    max_new = torch.max(updated * mask)
    max_abs_delta = torch.max(torch.abs(updated - recon) * mask)
    restore = torch.as_tensor(should_restore, device=consensus.device)
    return (
        torch.where(restore, prev_recon, updated),
        torch.where(restore, prev_recon, recon),
        num_updated, max_new, max_abs_delta,
    )


# --------------------------------------------------------- CUDA wrappers
def _check(tensors, what: str):
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {first.device}")
    if not fused_elementwise_supported(first.shape):
        raise ValueError(f"{what}: shape {tuple(first.shape)} fails fused_elementwise_supported")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: inputs must be float32, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{what}: inputs differ in shape or device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and 16-byte aligned")


def _launch_shape(shape) -> tuple[int, int]:
    """(blocks, threads) of both kernels: one 4-voxel quad of x a thread,
    whole rows a block, a grid of at most 2048 blocks that depends on the
    shape alone (so the fold order does too)."""
    nz, ny, nx = (int(v) for v in shape)
    return min(nz * ny, _MAX_BLOCKS), min(nx // 4, 1024)


def _bounds(shape, pad_width) -> list[int]:
    return [int(v) for v in shape] + [int(v) for pair in pad_width for v in pair]


def ratio_kld_cuda(hu, split1, split2, pad_width):
    """K4 on CUDA tensors; same contract as :func:`ratio_kld`, with the
    KLDs as float64 0-d tensors on the device."""
    _check((hu, split1, split2), "ratio_kld")
    blocks, threads = _launch_shape(hu.shape)
    r1, r2 = torch.empty_like(hu), torch.empty_like(hu)
    partials = torch.empty((blocks, 6), dtype=torch.float64, device=hu.device)
    status = _build.kernels().ratio_kld_f32(
        hu.data_ptr(), split1.data_ptr(), split2.data_ptr(), r1.data_ptr(), r2.data_ptr(),
        partials.data_ptr(), *_bounds(hu.shape, pad_width), blocks, threads,
        _build.stream_handle(hu.device),
    )
    _build.check(status, "ratio_kld")
    count("launch.ratio_kld_f32")
    sp, sq1, sq2, spp, st1, st2 = partials.sum(dim=0).unbind()
    frac = spp / sp
    kld1 = st1 / sp - torch.log(sp / sq1) * frac
    kld2 = st2 / sp - torch.log(sp / sq2) * frac
    return r1, r2, (kld1, kld2)


def update_select_cuda(consensus, recon, prev_recon, ht, should_restore, pad_width):
    """K5 on CUDA tensors; same contract as :func:`update_select`."""
    _check((consensus, recon, prev_recon, ht), "update_select")
    blocks, threads = _launch_shape(consensus.shape)
    flag = torch.as_tensor(should_restore, device=consensus.device).to(torch.int32).reshape(1)
    new_recon, new_prev = torch.empty_like(recon), torch.empty_like(recon)
    counts = torch.empty(blocks, dtype=torch.int64, device=consensus.device)
    maxima = torch.empty((blocks, 2), dtype=torch.float32, device=consensus.device)
    status = _build.kernels().update_select_f32(
        consensus.data_ptr(), recon.data_ptr(), prev_recon.data_ptr(), ht.data_ptr(),
        flag.data_ptr(), new_recon.data_ptr(), new_prev.data_ptr(), counts.data_ptr(),
        maxima.data_ptr(), *_bounds(consensus.shape, pad_width), blocks, threads,
        _build.stream_handle(consensus.device),
    )
    _build.check(status, "update_select")
    count("launch.update_select_f32")
    max_new, max_abs_delta = maxima.max(dim=0).values.unbind()
    return new_recon, new_prev, counts.sum(), max_new, max_abs_delta


# ------------------------------------------------------------ entry points
def _takes_kernel(t) -> bool:
    return t.device.type == "cuda" and fused_elementwise_supported(t.shape)


def ratio_kld(hu, split1, split2, pad_width):
    """Update ratios and split KLDs of one iteration on the padded volume:
    ``(ratio1, ratio2, (kld1, kld2))``, equal to ``mask·split/denom`` and
    ``kl_div_plain(hu, split, mask)`` up to reduction order (K4)."""
    if _takes_kernel(hu):
        return ratio_kld_cuda(hu, split1, split2, pad_width)
    return ratio_kld_plain(hu, split1, split2, pad_width)


def update_select(consensus, recon, prev_recon, ht, should_restore, pad_width):
    """Consensus-gated update, restore select and convergence statistics:
    ``(new_recon before the boundary rewrite, new_prev, num_updated (int64),
    max_new, max_abs_delta)`` (K5). ``should_restore`` is a bool (0-d
    tensor or Python) read on the device, so the caller need not wait for
    it."""
    if _takes_kernel(consensus):
        return update_select_cuda(consensus, recon, prev_recon, ht, should_restore, pad_width)
    return update_select_plain(consensus, recon, prev_recon, ht, should_restore, pad_width)
