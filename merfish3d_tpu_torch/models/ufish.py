"""Spot-probability predictors (counterpart of
``merfish3d_tpu/models/ufish.py``): the U-FISH CNN and the deterministic
DoG fallback.

The reference runs the U-FISH U-Net per z-plane on each deconvolved
readout bit; its probability map weights the readout images at decode
time. The port has one formulation of the network, the one the
reference's ``_FastUNet`` runs: BatchNorm folded into the conv weights in
f32 on the host, then every convolution with bf16 operands, f32 sums and a
fused bias + activation epilogue that writes bf16 (K11,
:func:`..ops.conv2d.conv2d_same`, on the card; each conv keeps its bf16
weights packed once for the kernel). Max-pool, nearest resize
and concatenation are exact on the bf16 activations; the map is returned
in f32.

Checkpoints are the reference's variables dict (``{"params": ...,
"batch_stats": ...}`` under Flax's module names, numpy arrays), pickled
or converted from a published ONNX file (:mod:`.ufish_onnx`);
:func:`params_from_flax` turns one into this module's weights.
"""

from __future__ import annotations

import functools
import os
import pickle
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.conv2d import PackedWeights, conv2d_same, pack_weights
from ..ops.filters import gaussian_lowpass
from ..utils import profiling
from .ufish_onnx import load_ufish_onnx_params, seeded_onnx_initializers, structural_onnx_to_flax

UFISH_MODEL_ALIASES = {
    # the reference's alias table (`DataRegistration.UFISH_MODEL_ALIASES`)
    "merfish": "finetune_models/v1.0.1-MERFISH_model.onnx",
    "seqfish": "finetune_models/v1.0.1-seqFISH_model.onnx",
    "simfish": "finetune_models/v1.0.1-simfish_model.onnx",
    "smfish": "finetune_models/v1.0.1-simfish_model.onnx",
    "deepspot": "finetune_models/v1.0.1-deepspot_model.onnx",
    "exseq": "finetune_models/v1.0.1-ExSeq_model.onnx",
    # base (non-finetuned) published model
    "alldata": "v1.0-alldata-ufish_c32.onnx",
    "default": "finetune_models/v1.0.1-simfish_model.onnx",
}
DEFAULT_UFISH_MODEL = "simfish"
BN_EPS = 1e-5


def resolve_checkpoint(model_name: str) -> Optional[Path]:
    """The local checkpoint file of a model alias: searched under
    ``$MERFISH3D_UFISH_MODEL_DIR``, then ``~/.ufish/models`` (where the
    upstream U-FISH package caches downloads), at the alias's relative
    path and by its file name. None when there is none: nothing is ever
    downloaded."""
    rel = UFISH_MODEL_ALIASES.get(model_name.lower())
    if rel is None:
        return None
    roots = []
    env = os.environ.get("MERFISH3D_UFISH_MODEL_DIR")
    if env:
        roots.append(Path(env))
    roots.append(Path.home() / ".ufish" / "models")
    for root in roots:
        for candidate in (root / rel, root / Path(rel).name):
            if candidate.exists():
                return candidate
    return None


def median_last(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Median over the trailing ``dims`` axes, averaging the two middle
    values of an even count as numpy and jnp do (``torch.median`` returns
    the lower one). Sort-based, so no 2**24-element limit."""
    flat = x.reshape(*x.shape[: x.ndim - dims], -1)
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


# ------------------------------------------------------------ the weights
def _fold_bn(kernel, bias, bn, stats, eps=BN_EPS):
    """Fold inference-mode BatchNorm into the preceding conv's kernel and
    bias in f32, as the reference's ``_fold_bn``:
    y = scale·(conv(x) + b − mean)/sqrt(var + eps) + shift."""
    s = np.asarray(bn["scale"], np.float32) / np.sqrt(np.asarray(stats["var"], np.float32) + eps)
    k = np.asarray(kernel, np.float32) * s
    b = (np.asarray(bias, np.float32) - np.asarray(stats["mean"], np.float32)) * s + np.asarray(
        bn["bias"], np.float32
    )
    return k, b


def topology_from_flax(variables: dict) -> dict:
    """(base_features, depths, up_mode) of a variables dict: the base from
    the first conv's width, the depths from the encoder and bottleneck
    blocks' widths, the decoder from the presence of ConvTranspose weights
    (the reference's ``UFishPredictor`` inference)."""
    p = variables["params"]
    base = int(np.asarray(p["ConvBlock_0"]["Conv_0"]["kernel"]).shape[-1])
    n_levels = (sum(1 for k in p if k.startswith("ConvBlock_")) + 1) // 2
    depths = tuple(
        int(np.asarray(p[f"ConvBlock_{i}"]["Conv_0"]["kernel"]).shape[-1]) // base
        for i in range(n_levels)
    )
    up_mode = "convtranspose" if any(k.startswith("ConvTranspose_") for k in p) else "resize"
    return {"base_features": base, "depths": depths, "up_mode": up_mode}


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The weight carrier: a reference variables dict → the state of
    :class:`UFishNet` (f32 HWIO tensors on the CPU). Each ConvBlock conv
    has its BatchNorm folded in (with no running statistics, BatchNorm is
    the affine map alone); each ConvTranspose(2x2, stride 2) becomes the
    1x1 conv to kh·kw·Co channels that :meth:`UFishNet.forward` follows
    with a depth-to-space, its kernel flipped (Flax places ``K[1−a, 1−b]``
    at output sub-position (a, b)) and its bias tiled."""
    p = variables["params"]
    stats = variables.get("batch_stats", {})
    topo = topology_from_flax(variables)
    n_levels = len(topo["depths"])
    state: dict[str, np.ndarray] = {}
    for i in range(2 * n_levels - 1):
        bp, bs = p[f"ConvBlock_{i}"], stats.get(f"ConvBlock_{i}", {})
        for j in (0, 1):
            conv, bn = bp[f"Conv_{j}"], bp[f"BatchNorm_{j}"]
            st = bs.get(f"BatchNorm_{j}") or {
                "mean": np.zeros_like(bn["bias"]), "var": np.ones_like(bn["scale"]),
            }
            k, b = _fold_bn(conv["kernel"], conv["bias"], bn, st)
            state[f"blocks.{i}.{j}.weight"], state[f"blocks.{i}.{j}.bias"] = k, b
    convtranspose = topo["up_mode"] == "convtranspose"
    for i in range(n_levels - 1):
        leaf = p[("ConvTranspose_" if convtranspose else "Conv_") + str(i)]
        k = np.asarray(leaf["kernel"], np.float32)
        b = np.asarray(leaf["bias"], np.float32)
        if convtranspose:
            kh, kw, cin, co = k.shape
            k = k[::-1, ::-1].transpose(2, 0, 1, 3).reshape(1, 1, cin, kh * kw * co)
            b = np.tile(b, kh * kw)
        state[f"ups.{i}.weight"], state[f"ups.{i}.bias"] = k, b
    head = p["Conv_0" if convtranspose else f"Conv_{n_levels - 1}"]
    state["head.weight"] = np.asarray(head["kernel"], np.float32)
    state["head.bias"] = np.asarray(head["bias"], np.float32)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}


class _Conv(nn.Module):
    """One SAME convolution: f32 weight (kh, kw, Cin, Co) and bias (Co,),
    run in the input's type through K11 with the epilogue ``act``. After
    :meth:`prepare`, bf16 inputs on the weight's device use the bf16 copy
    packed for the kernel then, instead of casting (and on the card
    packing) the weight on every call."""

    def __init__(self, kh: int, kw: int, cin: int, co: int, act: str):
        super().__init__()
        self.act = act
        self.register_buffer("weight", torch.zeros((kh, kw, cin, co)))
        self.register_buffer("bias", torch.zeros(co))
        self.packed: Optional[PackedWeights] = None

    def prepare(self) -> None:
        """Pack the weight as it is now, on its device; call again after
        changing it."""
        self.packed = pack_weights(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.packed
        if x.dtype == torch.bfloat16 and p is not None and p.data.device == x.device:
            return conv2d_same(x, p, self.bias, act=self.act)
        return conv2d_same(x, self.weight.to(x.dtype), self.bias, act=self.act)


class UFishNet(nn.Module):
    """2D U-Net of the U-FISH family on NHWC planes: a double 3x3 conv
    block (BatchNorm folded, relu) per level, 2x2 max-pool between
    encoder levels, per decoder level a ConvTranspose(2x2, stride 2) or a
    nearest ×2 resize + Conv(2x2), the skip concatenated after it, a
    block, and a 1x1 sigmoid head. ``forward`` mirrors the reference's
    ``_FastUNet.__call__``; its weights come from :func:`params_from_flax`."""

    def __init__(self, base_features: int = 32, depths: Sequence[int] = (1, 2, 4),
                 up_mode: str = "resize"):
        super().__init__()
        if up_mode not in ("resize", "convtranspose"):
            raise ValueError(f"up_mode must be 'resize' or 'convtranspose', got {up_mode!r}")
        self.base_features, self.depths, self.up_mode = int(base_features), tuple(depths), up_mode
        f = [self.base_features * d for d in self.depths]
        self.n_levels = len(f)

        def block(cin, co):
            return nn.ModuleList([_Conv(3, 3, cin, co, "relu"), _Conv(3, 3, co, co, "relu")])

        widths = [1] + f[:-1]
        blocks = [block(widths[i], f[i]) for i in range(self.n_levels)]
        ups = []
        for i in range(self.n_levels - 1):
            cin, co = f[-1 - i], f[-2 - i]
            if up_mode == "convtranspose":
                ups.append(_Conv(1, 1, cin, 4 * co, "none"))
            else:
                ups.append(_Conv(2, 2, cin, co, "none"))
            blocks.append(block(2 * co, co))
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = _Conv(1, 1, f[0], 1, "sigmoid")

    @classmethod
    def from_flax(cls, variables: dict) -> "UFishNet":
        net = cls(**topology_from_flax(variables))
        net.load_state_dict(params_from_flax(variables))
        return net

    def prepare(self) -> "UFishNet":
        """Pack every convolution's weights for K11 (:meth:`_Conv.prepare`)."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.prepare()
        return self

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))

    def _up(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        n, h, w, c = x.shape
        if self.up_mode == "convtranspose":
            # 1x1 conv to (2·2·Co) channels, then depth-to-space:
            # (n, h, w, kh, kw, co) -> (n, h, kh, w, kw, co)
            y = self.ups[idx](x)
            co = y.shape[-1] // 4
            return y.reshape(n, h, w, 2, 2, co).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, co)
        x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
        return self.ups[idx](x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) in the compute type -> (B, H, W, 1) probabilities
        in the same type; H and W divisible by 2**(levels − 1)."""
        skips = []
        for i in range(self.n_levels - 1):
            for conv in self.blocks[i]:
                x = conv(x)
            skips.append(x)
            x = self._pool(x)
        for conv in self.blocks[self.n_levels - 1]:
            x = conv(x)
        for idx in range(self.n_levels - 1):
            x = torch.cat([self._up(x, idx), skips[-1 - idx]], dim=-1)
            for conv in self.blocks[self.n_levels + idx]:
                x = conv(x)
        return self.head(x)


# ---------------------------------------------------------- the predictor
@functools.lru_cache(maxsize=None)
def _percentile_taps(n: int) -> tuple[tuple[int, int, float, float], ...]:
    """(low index, high index, low weight, high weight) of the 1st and
    99.8th percentiles among ``n`` sorted values: the position
    ``pct/100 · (n − 1)``, its floor and ceiling, and the linear weights,
    all in f32 on the host as ``jnp.percentile`` computes them. Python
    numbers, so no call uploads them."""
    f32 = np.float32
    pos = np.array([1.0, 99.8], f32) / f32(100) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = f32(1) - hw
    return tuple((min(max(int(a), 0), n - 1), min(max(int(b), 0), n - 1), float(c), float(d))
                 for a, b, c, d in zip(low, high, lw, hw))


def percentile_normalize(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane U-FISH input normalization of (N, Y, X) f32 planes:
    ``clip((p − p1)/max(p99.8 − p1, 1e-6), 0, 1)`` with both percentiles
    interpolated linearly from one sort, in f32 as ``jnp.percentile`` does
    (``torch.quantile`` refuses inputs over 2**24 elements)."""
    flat = planes.reshape(planes.shape[0], -1)
    s = torch.sort(flat, dim=-1).values
    lo, hi = (s[:, a, None, None] * lw + s[:, b, None, None] * hw
              for a, b, lw, hw in _percentile_taps(s.shape[-1]))
    return torch.clamp((planes - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def _reflect_index(n: int, total: int, device) -> torch.Tensor:
    """Indices of numpy's ``reflect`` pad of an axis of length n to
    ``total`` (padding after the end), for any pad length."""
    i = torch.arange(total, device=device)
    period = max(2 * (n - 1), 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


class UFishPredictor(nn.Module):
    """U-FISH CNN inference with the reference's call contract.

    ``params`` is a reference variables dict (topology inferred from it);
    with none, a ``base_features`` (default 32) resize-decoder network is
    drawn by :func:`.ufish_onnx.seeded_onnx_initializers` from a seed that
    ``generator`` (default: seeded 0) draws; the reference's threefry draw
    cannot be reproduced. Planes are normalized per plane,
    reflect-padded to a multiple of ``pad_to``, run through the network in
    bf16 in batches of ``batch_size`` planes (the last padded with zero
    planes), cropped back and returned in f32."""

    kind = "cnn"

    def __init__(self, params: Optional[dict] = None, base_features: Optional[int] = None,
                 pad_to: int = 64, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            seed = int(torch.randint(2**31 - 1, (1,), generator=gen))
            params = structural_onnx_to_flax(
                seeded_onnx_initializers(seed, base_features or 32, up_mode="resize")
            )
        self.net = UFishNet.from_flax(params).to(device).prepare()
        self.pad_to = int(pad_to)
        self.model_name = "cnn"

    @property
    def device(self) -> torch.device:
        return self.net.head.weight.device

    @torch.no_grad()
    def predict_planes(self, planes: torch.Tensor, batch_size: int = 8) -> torch.Tensor:
        """(N, Y, X) planes on the predictor's device -> (N, Y, X) f32
        probabilities. One batch's activations are live at a time."""
        planes = planes.to(self.device, torch.float32)
        n, ny, nx = planes.shape
        bs = min(max(1, int(batch_size)), n)
        py, px = -(-ny // self.pad_to) * self.pad_to, -(-nx // self.pad_to) * self.pad_to
        iy = _reflect_index(ny, py, planes.device)
        ix = _reflect_index(nx, px, planes.device)
        out = torch.empty((n, ny, nx), dtype=torch.float32, device=planes.device)
        for start in range(0, n, bs):
            with profiling.span("ufish.normalize"):
                chunk = percentile_normalize(planes[start : start + bs])
                m = chunk.shape[0]
                chunk = chunk[:, iy][:, :, ix]
                if m < bs:
                    chunk = torch.cat([chunk, chunk.new_zeros((bs - m, py, px))])
            with profiling.span("ufish.net"):
                profiling.count("ufish.planes", m)
                prob = self.net(chunk[..., None].to(torch.bfloat16))[..., 0]
            out[start : start + m] = prob[:m, :ny, :nx].float()
        return out

    def forward(self, volumes: torch.Tensor, batch_size: int = 8) -> torch.Tensor:
        """(bits, Z, Y, X) -> f32 probabilities of the same shape: the CNN
        is per plane, so bits × z planes fold into one batch axis."""
        nb, nz, ny, nx = volumes.shape
        return self.predict_planes(volumes.reshape(nb * nz, ny, nx), batch_size).reshape(nb, nz, ny, nx)

    def predict(self, volume, batch_size: int = 8) -> np.ndarray:
        """Per-plane prediction over a (Z, Y, X) volume, numpy in and out."""
        vol = torch.as_tensor(np.asarray(volume, np.float32))
        return self.predict_planes(vol, batch_size).cpu().numpy()

    def predict_batch(self, volumes, batch_size: int = 8) -> np.ndarray:
        """Batched (bits, Z, Y, X) prediction, numpy in and out."""
        vols = torch.as_tensor(np.asarray(volumes, np.float32))
        return self.forward(vols, batch_size).cpu().numpy()


class DoGSpotPredictor(nn.Module):
    """Parameter-free spot predictor: per-plane difference of Gaussians
    matched to the diffraction-limited spot scale, divided by a robust
    per-plane noise scale (1.4826 × the median absolute DoG response) and
    squashed through a sigmoid. ``forward((..., Z, Y, X)) -> [0, 1]``
    probability of the same shape, float32 on the input's device."""

    kind = "dog"

    def __init__(self, sigma_spot: float = 1.3, sigma_bg: float = 2.6,
                 gain: float = 4.0, center: float = 5.0):
        super().__init__()
        self.sigma_spot = float(sigma_spot)
        self.sigma_bg = float(sigma_bg)
        self.gain = float(gain)
        # operating point in MAD units: Poisson noise peaks reach 2-3 MAD
        # per plane, so a lower center turns noise into decodable junk
        self.center = float(center)
        self.model_name = "dog"

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        vol = volume.to(torch.float32)
        fine = gaussian_lowpass(vol, sigma=(0.0, self.sigma_spot, self.sigma_spot))
        coarse = gaussian_lowpass(vol, sigma=(0.0, self.sigma_bg, self.sigma_bg))
        dog = fine - coarse
        mad = median_last(dog.abs(), dims=2)[..., None, None]
        score = dog / torch.clamp(mad * 1.4826, min=1e-6)
        return torch.sigmoid(self.gain * (score - self.center))


# ------------------------------------------------------------- loading
_NUMPY_GLOBALS = {
    (module, name)
    for module in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
    for name in ("_reconstruct", "ndarray", "dtype", "scalar")
}


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles dicts of numpy arrays and nothing else: any other global
    is refused before it is built."""

    def find_class(self, module, name):
        if (module, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}; a U-FISH checkpoint pickle holds only "
                "dicts of numpy arrays"
            )
        return super().find_class(module, name)


def _check_arrays(tree, path: str = "") -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_arrays(v, f"{path}/{k}")
    elif not isinstance(tree, np.ndarray):
        raise TypeError(
            f"checkpoint entry {path or '/'} is a {type(tree).__name__}; a U-FISH checkpoint "
            "holds only dicts of numpy arrays"
        )


def load_checkpoint(path) -> dict:
    """A reference variables dict from a ``.onnx`` file (converted
    structurally) or a pickle of numpy arrays."""
    if str(path).endswith(".onnx"):
        return load_ufish_onnx_params(path)
    with open(path, "rb") as fh:
        variables = _NumpyUnpickler(fh).load()
    _check_arrays(variables)
    if "params" not in variables:
        raise ValueError(f"checkpoint {path} has no 'params' entry: keys {sorted(variables)}")
    return variables


def get_predictor(model_name: str = DEFAULT_UFISH_MODEL, checkpoint_path=None, device="cuda"):
    """Resolve a spot predictor by name. ``checkpoint_path`` may be a
    U-FISH ``.onnx`` file or a pickled variables dict; without one the
    alias is looked up locally (:func:`resolve_checkpoint`). ``"dog"`` or
    ``"none"`` asks for the DoG predictor; an alias with no local file
    falls back to it with a warning. The result carries ``kind`` ("cnn" or
    "dog") and ``model_name``."""
    if model_name.lower() in ("dog", "none") and checkpoint_path is None:
        return DoGSpotPredictor()
    explicit = checkpoint_path is not None
    if checkpoint_path is None:
        checkpoint_path = resolve_checkpoint(model_name)
    if checkpoint_path is not None:
        pred = UFishPredictor(params=load_checkpoint(checkpoint_path), device=device)
        pred.model_name = str(checkpoint_path) if explicit else str(model_name)
        return pred
    # loud: a user asking for a CNN must know a DoG filter, not a CNN, is
    # producing their probability maps
    warnings.warn(
        f"U-FISH model '{model_name}' resolved to no local checkpoint "
        "(searched $MERFISH3D_UFISH_MODEL_DIR and ~/.ufish/models); "
        "falling back to the deterministic DoG spot predictor. Spot "
        "probabilities will NOT come from a CNN.",
        stacklevel=2,
    )
    pred = DoGSpotPredictor()
    pred.model_name = "dog-fallback"
    return pred
