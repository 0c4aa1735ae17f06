"""Seeded U-FISH weights: a variables dict drawn from the run's seed.

A configuration whose ``decode`` holds ``predictor_weights`` (e.g.
``{"base_features": 32, "depths": [1, 2, 4], "up_mode":
"convtranspose"}``) scores spots with a U-FISH U-Net of that topology.
:func:`draw_ufish` draws its variables with numpy on the CPU, on a stream
of the seed of its own, under Flax's module names (kernels HWIO), as a
published checkpoint converts: ``params`` with ``ConvBlock_i/Conv_j`` and
``BatchNorm_j``, the decoder's ``ConvTranspose_i`` (or ``Conv_i`` of the
resize decoder) and the head, and ``batch_stats``.

- kernels He-normal (std sqrt(2 / fan-in); a stride-2 2×2 transposed conv
  gives each output one tap of each input channel, fan-in its channels);
  conv biases N(0, 0.1²);
- BatchNorm far from the identity, so that a fold that drops or misplaces
  a term shows: scale U(0.5, 1.5), shift N(0, 0.2²), running mean
  N(0, 0.2²), running variance U(0.5, 2);
- the head's kernel N(0, 1 / fan-in) and its bias N(0, 0.25²): the logits
  stay within a few units of 0, off the sigmoid's rails (at base 32 on
  two bits of a (12, 192, 192) tile of ``prod_rigid``, every probability
  lies in (0.02, 0.98)).

:func:`write_checkpoint` pickles the dict for the program's
``ufish_checkpoint`` option; the reference is handed the dict itself.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .generator import stream_seed

WEIGHTS_STREAM = 0x75666973  # a stream no tile of the seed draws from


def draw_ufish(seed: int, base_features: int, depths, up_mode: str) -> dict:
    if up_mode not in ("convtranspose", "resize"):
        raise ValueError(f"up_mode must be 'convtranspose' or 'resize', got {up_mode!r}")
    rng = np.random.default_rng(stream_seed(seed, WEIGHTS_STREAM))
    f32 = np.float32
    widths = [int(base_features) * int(d) for d in depths]
    levels = len(widths)

    def conv(kh, kw, cin, co):
        return {"kernel": (rng.standard_normal((kh, kw, cin, co)) * np.sqrt(2.0 / (kh * kw * cin))).astype(f32),
                "bias": (0.1 * rng.standard_normal(co)).astype(f32)}

    def batch_norm(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(f32), "bias": (0.2 * rng.standard_normal(c)).astype(f32)},
                {"mean": (0.2 * rng.standard_normal(c)).astype(f32), "var": rng.uniform(0.5, 2.0, c).astype(f32)})

    params, stats = {}, {}

    def block(i, cin, co):
        p, s = {}, {}
        for j, c in enumerate((cin, co)):
            p[f"Conv_{j}"] = conv(3, 3, c, co)
            p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = batch_norm(co)
        params[f"ConvBlock_{i}"], stats[f"ConvBlock_{i}"] = p, s

    for i in range(levels):
        block(i, 1 if i == 0 else widths[i - 1], widths[i])
    for i in range(levels - 1):
        cin, co = widths[-1 - i], widths[-2 - i]
        if up_mode == "convtranspose":
            params[f"ConvTranspose_{i}"] = {
                "kernel": (rng.standard_normal((2, 2, cin, co)) * np.sqrt(2.0 / cin)).astype(f32),
                "bias": (0.1 * rng.standard_normal(co)).astype(f32)}
        else:
            params[f"Conv_{i}"] = conv(2, 2, cin, co)
        block(levels + i, 2 * co, co)
    head = "Conv_0" if up_mode == "convtranspose" else f"Conv_{levels - 1}"
    params[head] = {"kernel": (rng.standard_normal((1, 1, widths[0], 1)) / np.sqrt(widths[0])).astype(f32),
                    "bias": (0.25 * rng.standard_normal(1)).astype(f32)}
    return {"params": params, "batch_stats": stats}


def write_checkpoint(variables: dict, path: Path) -> Path:
    """Pickle ``variables`` to ``path``; protocol 4, which rebuilds an array
    through ``numpy``'s ``_reconstruct``, the only builder a checkpoint
    loader that refuses other globals needs to admit."""
    with open(path, "wb") as fh:
        pickle.dump(variables, fh, protocol=4)
    return path
