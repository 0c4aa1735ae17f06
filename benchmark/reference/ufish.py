"""The U-FISH spot predictor in plain torch, float32 with TF32 off.

The published layer order, from a variables dict under Flax's module
names (``params`` with ``ConvBlock_i/{Conv_j, BatchNorm_j}``,
``ConvTranspose_i`` or the resize decoder's ``Conv_i``, the head, and
``batch_stats``), kernels HWIO:

- per plane, ``clip((p − p1) / max(p99.8 − p1, 1e-6), 0, 1)`` with both
  percentiles interpolated linearly;
- reflect padding (no edge repeat) after the end of y and x to a multiple
  of 64;
- per encoder level Conv(3×3, SAME) → BatchNorm (inference: the running
  statistics, not folded into the conv) → ReLU, twice, then a 2×2
  max-pool; the bottleneck block;
- per decoder level a ConvTranspose(2×2, stride 2), or a nearest ×2
  resize and a Conv(2×2, SAME: no padding before, one after), the skip
  concatenated after it, and a block;
- a 1×1 conv and a sigmoid, cropped back to the input's size.

Every layer's output goes through :func:`.precision.q`, so the control
runs the chain in bfloat16 with TF32 convolutions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .precision import low, q

BN_EPS = 1e-5
PAD_TO = 64


@contextlib.contextmanager
def _working_tf32():
    """TF32 off in float32, on in the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = low()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def topology(variables: dict) -> tuple[int, str]:
    """(levels, decoder) of a variables dict: the ConvBlocks are 2·levels − 1."""
    p = variables["params"]
    levels = (sum(k.startswith("ConvBlock_") for k in p) + 1) // 2
    return levels, "convtranspose" if any(k.startswith("ConvTranspose_") for k in p) else "resize"


class UFish:
    """The network of one variables dict, on ``device``."""

    def __init__(self, variables: dict, device):
        self.levels, self.up_mode = topology(variables)
        self.p = _tensors(variables["params"], device)
        self.stats = _tensors(variables.get("batch_stats", {}), device)

    def _conv(self, x, leaf, pad):
        """NCHW ``x`` through a Flax conv leaf (HWIO kernel); ``pad`` as
        ``F.pad``'s (left, right, top, bottom)."""
        w = leaf["kernel"].permute(3, 2, 0, 1)
        return q(F.conv2d(F.pad(x, pad), w, leaf["bias"]))

    def _block(self, x, i):
        for j in (0, 1):
            x = self._conv(x, self.p[f"ConvBlock_{i}"][f"Conv_{j}"], (1, 1, 1, 1))
            bn = self.p[f"ConvBlock_{i}"][f"BatchNorm_{j}"]
            st = self.stats.get(f"ConvBlock_{i}", {}).get(f"BatchNorm_{j}")
            if st is not None:
                x = (x - st["mean"][:, None, None]) / torch.sqrt(st["var"][:, None, None] + BN_EPS)
            x = q(torch.relu(q(x * bn["scale"][:, None, None] + bn["bias"][:, None, None])))
        return x

    def _up(self, x, i):
        if self.up_mode == "convtranspose":
            leaf = self.p[f"ConvTranspose_{i}"]
            # Flax's transposed conv puts tap K[1 − a, 1 − b] at output
            # sub-position (a, b); torch's puts W[a, b] there
            w = leaf["kernel"].flip(0, 1).permute(2, 3, 0, 1)
            return q(F.conv_transpose2d(x, w, leaf["bias"], stride=2))
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self._conv(x, self.p[f"Conv_{i}"], (0, 1, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 1, H, W) → (N, 1, H, W) probabilities; H and W divisible by
        2**(levels − 1)."""
        skips = []
        for i in range(self.levels - 1):
            x = self._block(x, i)
            skips.append(x)
            x = q(F.max_pool2d(x, 2))
        x = self._block(x, self.levels - 1)
        for i in range(self.levels - 1):
            x = torch.cat([self._up(x, i), skips[-1 - i]], dim=1)
            x = self._block(x, self.levels + i)
        head = self.p["Conv_0" if self.up_mode == "convtranspose" else f"Conv_{self.levels - 1}"]
        return q(torch.sigmoid(self._conv(x, head, (0, 0, 0, 0))))


def _tensors(tree: dict, device) -> dict:
    return {k: _tensors(v, device) if isinstance(v, dict) else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def percentile_normalize(planes: torch.Tensor) -> torch.Tensor:
    """(N, Y, X) → each plane scaled by its 1st and 99.8th percentiles
    (linear interpolation between the order statistics), clipped to [0, 1]."""
    s = torch.sort(planes.reshape(planes.shape[0], -1), dim=-1).values
    n = s.shape[-1]
    bounds = []
    for pct in (1.0, 99.8):
        pos = pct / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        bounds.append(s[:, lo] * (1.0 - frac) + s[:, hi] * frac)
    low_, high_ = (b[:, None, None] for b in bounds)
    return torch.clamp((planes - low_) / torch.clamp(high_ - low_, min=1e-6), 0.0, 1.0)


def _reflect(n: int, total: int, device) -> torch.Tensor:
    """Indices of a reflect pad (no edge repeat) of an axis of length n to ``total``."""
    period = max(2 * (n - 1), 1)
    i = torch.arange(total, device=device) % period
    return torch.where(i >= n, period - i, i)


@torch.no_grad()
def ufish_probability(volumes: torch.Tensor, net: UFish, batch: int = 8) -> torch.Tensor:
    """(B, Z, Y, X) → float32 probabilities of the same shape, plane by
    plane, ``batch`` planes at a time."""
    b, nz, ny, nx = volumes.shape
    planes = volumes.reshape(b * nz, ny, nx).to(torch.float32)
    py, px = -(-ny // PAD_TO) * PAD_TO, -(-nx // PAD_TO) * PAD_TO
    iy, ix = _reflect(ny, py, planes.device), _reflect(nx, px, planes.device)
    out = torch.empty_like(planes)
    with _working_tf32():
        for start in range(0, planes.shape[0], batch):
            x = q(percentile_normalize(planes[start : start + batch]))
            x = x[:, iy][:, :, ix][:, None]
            out[start : start + batch] = net.forward(x)[:, 0, :ny, :nx]
    return out.reshape(b, nz, ny, nx)
