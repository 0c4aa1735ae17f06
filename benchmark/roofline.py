"""The card's published peaks and the least work of an RLGC solve.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense): FP32 outside the tensor cores 67 TFLOP/s, HBM 3.35 TB/s.

The least time of one RLGC-GC volume-iteration follows the algorithm, not
the kernels that run it, at the padded shape N = Z·Y·X:

- four convolutions through the spectrum: the forward model of the real
  recon, the adjoint of each of the two real ratios and the consensus of
  one real volume; each is a forward and an inverse 3-D DFT of a real
  volume and one complex product;
- a DFT counts 5·n·log2(n) flops per complex line of length n on every
  axis, half on the first axis of a real input (and on the last axis of a
  real output); a complex product 6 flops an element;
- bytes: each convolution reads its real input and the complex OTF and
  writes its real output; the split reads the counts and writes one
  split; the ratios and KLDs read the forward model and the two splits
  and write two ratios; the update reads the consensus, both adjoints,
  the recon and the previous recon and writes the recon and the previous
  recon; all float32.

The least time is the larger of flops over the FP32 peak and bytes over
the HBM rate.
"""

from __future__ import annotations

import math

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def real_dft_flops(shape) -> float:
    """Forward (or inverse) 3-D DFT of a real volume (to or from a real
    volume)."""
    n = math.prod(shape)
    return sum(5.0 * n * math.log2(m) * (0.5 if ax == 0 else 1.0) for ax, m in enumerate(shape) if m > 1)


def rlgc_iteration_work(padded_shape) -> tuple[float, float]:
    """(flops, bytes) of one RLGC-GC volume-iteration at ``padded_shape``."""
    n = math.prod(padded_shape)
    conv_flops = 2.0 * real_dft_flops(padded_shape) + 6.0 * n
    conv_bytes = 4.0 * n + 8.0 * n + 4.0 * n
    flops = 4 * conv_flops
    elementwise_bytes = 4.0 * n * ((1 + 1) + (3 + 2) + (5 + 2))
    return flops, 4 * conv_bytes + elementwise_bytes


def rlgc_least_seconds(padded_shape, iterations: int) -> float:
    flops, nbytes = rlgc_iteration_work(padded_shape)
    return iterations * max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
