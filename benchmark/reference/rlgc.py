"""Richardson-Lucy Gradient-Consensus deconvolution, one volume at a time,
in plain torch.

Each iteration on the symmetrically padded volume: a binomial(n, 1/2)
split of the observed counts, the forward model ``Hu = conv(recon, otf)``,
both update ratios and split KLDs, the adjoint convolution of each ratio,
the consensus convolution of ``(ht1 - 1)(ht2 - 1)``, the consensus-gated
update with the restore select, the boundary re-symmetrization and the
host's stop decision (restore, or too few updated voxels or too small a
step from ``MIN_STOP_ITERS`` on).

The splits are the algorithm's: volume ``i`` of a batch seeded ``s`` draws
iteration ``k``'s split from a ``torch.Generator`` on the volume's device
seeded with ``SeedSequence([s + i, k])``; exact popcounts of masked random
bits for n <= 32, a rounded clipped normal above.
"""

from __future__ import annotations

import numpy as np
import torch

from .fftutils import (
    axis_linear_fft_padding,
    c_conj,
    c_mul,
    enforce_symmetric_boundary,
    fft_conv_full,
    fftn_spec,
    linear_fft_pad_width,
    observed_region_mask,
    pad_psf,
    pad_symmetric,
    remove_padding_zyx,
)
from .precision import q

MIN_STOP_ITERS = 3
_EPS_KLD = 1e-4

# the program's batch and crop budgets, which choose its solves and so
# their seeds
_BUDGET_PADDED_VOXELS = 9.0e7
_BATCH_F32_BUDGET = 2.2e9
_PAIR_WORKING_SET_BUFFERS = 16.0
_MAX_BATCH = 32


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def binomial_half(gen: torch.Generator, counts: torch.Tensor) -> torch.Tensor:
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
    return int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1, np.uint64)[0])


def binomial_split(observed: torch.Tensor, seed: int, iteration: int) -> torch.Tensor:
    gen = torch.Generator(device=observed.device)
    gen.manual_seed(split_seed(seed, iteration))
    return binomial_half(gen, observed)


def _kl_div(p, q_, mask):
    p = (p + _EPS_KLD) * mask
    q_ = (q_ + _EPS_KLD) * mask
    p = p / torch.sum(p)
    q_ = q_ / torch.sum(q_)
    kld = p * (torch.log(p) - torch.log(q_))
    return torch.sum(torch.where(torch.isnan(kld), torch.zeros_like(kld), kld))


def _solve(observed, psf, seed, pad_width, *, max_iters, limit=0.01, max_delta=0.001):
    """One padded volume. Returns (padded recon, iterations)."""
    dev = observed.device
    shape = observed.shape
    mask = observed_region_mask(shape, pad_width, device=dev)
    num_pixels = float(np.prod([s - b - a for s, (b, a) in zip(shape, pad_width)]))
    otf = fftn_spec(torch.as_tensor(pad_psf(psf, shape), device=dev))
    otf_t = c_conj(otf)
    otf2 = c_mul(otf, otf_t)
    update_norm = torch.clamp(fft_conv_full(mask, otf_t), min=1e-6)
    ok = update_norm >= 1e-3
    init = (torch.sum(observed * mask) / num_pixels).expand(shape).contiguous()
    recon, prev = init, init
    prev_kld = (float("inf"), float("inf"))
    it = 0
    while it < max_iters:
        hu = fft_conv_full(recon, otf)
        split1 = binomial_split(observed, seed, it)
        split2 = observed - split1
        kld1, kld2 = _kl_div(hu, split1, mask), _kl_div(hu, split2, mask)
        denom = 0.5 * (hu + 1e-12)
        r1, r2 = q(mask * (split1 / denom)), q(mask * (split2 / denom))
        ht1 = torch.where(ok, fft_conv_full(r1, otf_t) / update_norm, 1.0)
        ht2 = torch.where(ok, fft_conv_full(r2, otf_t) / update_norm, 1.0)
        consensus = fft_conv_full((ht1 - 1.0) * (ht2 - 1.0), otf2)
        restore = it >= MIN_STOP_ITERS and bool(kld1 > prev_kld[0] or kld2 > prev_kld[1])
        updated = q(torch.where(consensus < 0, recon, recon * (ht1 + ht2)))
        if restore:
            return enforce_symmetric_boundary(prev, pad_width), it
        num_updated = float(torch.sum((consensus >= 0) & (mask > 0)))
        max_new = float(torch.max(updated * mask))
        max_abs_delta = float(torch.max(torch.abs(updated - recon) * mask))
        recon, prev = enforce_symmetric_boundary(updated, pad_width), recon
        prev_kld = (float(kld1), float(kld2))
        it += 1
        if it >= MIN_STOP_ITERS and (
            num_updated / num_pixels < limit or max_abs_delta / max(max_new, 1e-12) < max_delta
        ):
            break
    return recon, it


def rlgc_batch(images: torch.Tensor, psf, *, seed: int, max_iters: int):
    """Deconvolve a (B, Z, Y, X) stack sharing one PSF; volume ``i`` is
    seeded ``seed + i``. Returns (float32 stack, iterations per volume)."""
    psf = np.asarray(psf, np.float32)
    pad_width = linear_fft_pad_width(tuple(images.shape[1:]), psf.shape)
    out = torch.empty(images.shape, dtype=torch.float32, device=images.device)
    iters = []
    for i in range(images.shape[0]):
        padded = pad_symmetric(images[i].to(torch.float32), pad_width)
        recon, n = _solve(padded, psf, seed + i, pad_width, max_iters=max_iters)
        out[i] = remove_padding_zyx(recon, pad_width)
        iters.append(n)
    return out, iters


def max_batch(image_shape, psf_shape) -> int:
    """How many volumes of this shape one batch solve of the program takes."""
    padded = 1
    for n, s in zip(image_shape, psf_shape):
        padded *= int(n) + sum(axis_linear_fft_padding(int(n), s))
    b = int((_BATCH_F32_BUDGET / padded - _PAIR_WORKING_SET_BUFFERS) // 2.0)
    return max(1, min(b, _MAX_BATCH))


def auto_crop_yx(image_shape, psf_shape) -> int:
    """The lateral crop of the program's single-volume solve: the largest
    whose padded solve, a halo of twice the PSF's support included, fits
    the budget."""
    nz = int(image_shape[0])
    pz = nz + sum(axis_linear_fft_padding(nz, psf_shape[0]))
    halo_y, halo_x = 2 * int(psf_shape[1]), 2 * int(psf_shape[2])
    for crop in (4096, 3072, 2048, 1536, 1280, 1024, 768, 512, 384, 256):
        ey, ex = crop + halo_y, crop + halo_x
        py = ey + sum(axis_linear_fft_padding(ey, psf_shape[1]))
        px = ex + sum(axis_linear_fft_padding(ex, psf_shape[2]))
        if pz * py * px <= _BUDGET_PADDED_VOXELS:
            return crop
    return 256
