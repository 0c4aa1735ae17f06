"""Spectral transforms on (real, imag) float32 pairs (counterpart of the
spectral half of ``merfish3d_tpu/ops/fftutils.py`` and of the 3D dispatch
of ``merfish3d_tpu/ops/mmfft.py``).

:func:`fftn_spec` / :func:`ifftn_spec` keep the per-axis spectrum order
of :mod:`.pfft` (scrambled for Cooley-Tukey lengths, natural otherwise),
the order the reference's TPU dispatch produces; :func:`spectrum_freqs`
names the frequency at each position. 3D volumes go through the DFT
kernels where the reference's predicates take them — K10 (z and x in one
pass) then K7 (y) where :func:`.pfft.zx_supported`, else K6 (x), K7 (y)
and K8 (z) axis by axis in the reference's order. An axis no kernel takes
goes to ``torch.fft``, the counterpart of the reference's einsum FFT,
which runs outside Pallas; so do 2D and other ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pfft


def c_mul(a, b):
    """(ar, ai) * (br, bi) elementwise complex product on pairs."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def c_conj(a):
    ar, ai = a
    return ar, -ai


def fftn_pair(xr: torch.Tensor, xi=None):
    """Full-spectrum N-D DFT in natural order → (real, imag)."""
    z = torch.complex(xr.float(), xi.float()) if xi is not None else xr.to(torch.complex64)
    f = torch.fft.fftn(z)
    return f.real.contiguous(), f.imag.contiguous()


def ifftn_pair(xr: torch.Tensor, xi: torch.Tensor):
    z = torch.complex(xr.float(), xi.float())
    f = torch.fft.ifftn(z)
    return f.real.contiguous(), f.imag.contiguous()


def _axis(xr, xi, ax: int, *, inverse: bool, real_output: bool = False):
    """One axis through its kernel where the reference's predicate takes
    it, else through ``torch.fft`` in the same spectrum order."""
    if pfft.axis_supported(xr.shape, ax):
        return pfft.dft_axis_3d(xr, xi, ax, inverse=inverse, real_output=real_output)
    return pfft.axis_plain(xr, xi, ax, inverse, real_output)


def fftn_spec(xr: torch.Tensor, xi=None):
    """Forward N-D DFT pair in the spectrum order of :mod:`.pfft` (the
    reference's dispatch on the TPU, ``mmfft.fftn_pair_s``)."""
    xr = xr.to(torch.float32).contiguous()
    xi = None if xi is None else xi.to(torch.float32).contiguous()
    if xr.ndim == 3:
        if pfft.zx_supported(xr.shape):
            # z and x in one pass, while the input may still be real
            xr, xi = pfft.dft_zx(xr, xi)
            return _axis(xr, xi, 1, inverse=False)
        # trailing (largest) axis first, while the input may still be real
        for ax in (2, 1, 0):
            xr, xi = _axis(xr, xi, ax, inverse=False)
        return xr, xi
    for ax in range(xr.ndim):
        xr, xi = pfft.axis_plain(xr, xi, ax, False, False)
    return xr, xi


def ifftn_spec(xr: torch.Tensor, xi, real_output: bool = False):
    """Inverse of :func:`fftn_spec` (natural-order spatial output; the
    reference's ``mmfft.ifftn_pair_s``); ``real_output`` skips the
    imaginary channel of the last axis and returns ``(real, None)``."""
    xr = xr.to(torch.float32).contiguous()
    xi = None if xi is None else xi.to(torch.float32).contiguous()
    if xr.ndim == 3:
        if pfft.zx_supported(xr.shape):
            xr, xi = _axis(xr, xi, 1, inverse=True)
            return pfft.dft_zx(xr, xi, inverse=True, real_output=real_output)
        # trailing axis last, so real_output halves its work
        for ax in (1, 0, 2):
            xr, xi = _axis(xr, xi, ax, inverse=True, real_output=real_output and ax == 2)
        return xr, xi
    for ax in range(xr.ndim):
        last = ax == xr.ndim - 1
        xr, xi = pfft.axis_plain(xr, xi, ax, True, real_output and last)
    return xr, xi


def spectrum_freqs(n: int) -> np.ndarray:
    """1-D frequency values (cycles/sample) in :func:`fftn_spec`'s
    spectrum order for an axis of length n."""
    return np.fft.fftfreq(n).astype(np.float32)[pfft.scramble_perm(n)]
