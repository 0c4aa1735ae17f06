"""Structural ONNX → Flax-named weight conversion for ``UFishNet`` (a
copy of ``merfish3d_tpu/models/ufish_onnx.py``, pure numpy).

The port keeps the reference's variables dict — ``{"params": ...,
"batch_stats": ...}`` under Flax's module names, HWIO kernels — as its
checkpoint form, so a pickled reference checkpoint and a converted ONNX
file load alike; :func:`..ufish.params_from_flax` turns it into the
port's folded weights. :func:`seeded_onnx_initializers` makes a
checkpoint of any family from a numpy seed.

The published U-FISH checkpoints ship as ONNX files (reference
`DataRegistration._load_ufish_model:138-175` loads them with onnxruntime).
Exporter tensor *names* vary between torch versions, so this converter is
name-agnostic: torch exports initializers in module-registration order,
which for a sequential U-Net equals forward order, and that order plus the
tensor *shapes* identifies every parameter unambiguously.

The architecture itself is **inferred from the initializer stream**
(:func:`infer_topology`): base width from the first conv, level widths
from the encoder blocks, and the decoder upsampling flavor from the shape
of the 2×2 weights — torch ``ConvTranspose2d`` serializes ``(Cin, Cout,
2, 2)`` with ``Cin > Cout`` while a resize-then-``Conv2d(2×2)`` decoder
serializes ``(Cout, Cin, 2, 2)``.  A checkpoint outside this U-Net family
fails loudly with a full shape inventory plus the committed per-alias
expectations in ``ufish_topology.json``.

The expected module sequence for ``UFishNet(base_features, depths,
up_mode)`` (forward order, matching Flax's auto-naming in `ufish.py`):

- one ``ConvBlock`` per down level + bottleneck: Conv(3×3) → BatchNorm →
  Conv(3×3) → BatchNorm
- per up level: ConvTranspose(2×2, stride 2) — or Conv(2×2) after a
  nearest-neighbour upsample — then a ``ConvBlock``
- final Conv(1×1) projection

ONNX side, per Conv: 4D weight (O, I, kH, kW) + optional 1D bias (O,);
per ConvTranspose: 4D weight (I, O, kH, kW) + optional 1D bias; per
BatchNorm: four 1D tensors (gamma, beta, running_mean, running_var).
Convs feeding a BatchNorm are typically exported with ``bias=False`` —
both variants are accepted (a missing bias maps to zeros, matching the
affine identity).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from .onnx_reader import conv_to_flax, load_onnx_initializers

TOPOLOGY_SPEC_PATH = Path(__file__).with_name("ufish_topology.json")


def conv_transpose_to_flax(weight: np.ndarray) -> np.ndarray:
    """torch ``ConvTranspose2d`` weight (I, O, kH, kW) → Flax
    ``nn.ConvTranspose`` kernel (kH, kW, I, O).

    Flax's ``conv_transpose`` applies the kernel mirrored relative to
    torch's scatter convention, so the spatial axes are flipped here
    (the reference validates it against ``torch.nn.ConvTranspose2d``).
    """
    return np.transpose(weight, (2, 3, 0, 1))[::-1, ::-1].copy()


def module_sequence(
    base_features: int = 32,
    depths: Sequence[int] = (1, 2, 4),
    up_mode: str = "resize",
) -> list[tuple[str, str, int]]:
    """Forward-order (flax_path, kind, features) for UFishNet — kept in
    lockstep with `UFishNet.__call__` (`ufish.py`)."""
    f = [base_features * d for d in depths]
    seq: list[tuple[str, str, int]] = []
    n_blocks = 0
    n_convs = 0
    n_convt = 0

    def block(feats: int) -> None:
        nonlocal n_blocks
        prefix = f"ConvBlock_{n_blocks}"
        n_blocks += 1
        seq.append((f"{prefix}/Conv_0", "conv", feats))
        seq.append((f"{prefix}/BatchNorm_0", "bn", feats))
        seq.append((f"{prefix}/Conv_1", "conv", feats))
        seq.append((f"{prefix}/BatchNorm_1", "bn", feats))

    for feats in f[:-1]:
        block(feats)
    block(f[-1])
    for feats in reversed(f[:-1]):
        if up_mode == "convtranspose":
            seq.append((f"ConvTranspose_{n_convt}", "convT", feats))
            n_convt += 1
        else:
            seq.append((f"Conv_{n_convs}", "conv", feats))
            n_convs += 1
        block(feats)
    seq.append((f"Conv_{n_convs}", "conv", 1))
    return seq


def infer_topology(ordered: list[np.ndarray]) -> dict:
    """Derive (base_features, depths, up_mode) from an initializer stream.

    Walks the 4D conv weights: encoder double-conv widths until the first
    2×2 weight, whose (I, O) orientation identifies the decoder flavor.
    Raises ``ValueError`` with the shape inventory when the stream is not
    a UFishNet-family U-Net.
    """
    conv_ws = [t for t in ordered if t.ndim == 4]
    inventory = ", ".join(str(t.shape) for t in ordered)
    if not conv_ws:
        raise ValueError(
            f"stream does not match UFishNet family: no 4D conv weights: "
            f"[{inventory}]"
        )
    if conv_ws[0].shape[1] != 1 or conv_ws[0].shape[2:] != (3, 3):
        raise ValueError(
            "stream does not match UFishNet family: first conv is not a "
            f"(base, 1, 3, 3) stem: {conv_ws[0].shape}; stream: [{inventory}]"
        )
    base = int(conv_ws[0].shape[0])
    widths = []
    i = 0
    while i < len(conv_ws) and conv_ws[i].shape[2:] == (3, 3):
        w = conv_ws[i]
        if i + 1 >= len(conv_ws):
            raise ValueError(
                "stream does not match UFishNet family: encoder ends "
                f"without a decoder at conv {i}: [{inventory}]"
            )
        w2 = conv_ws[i + 1]
        if w2.shape[2:] != (3, 3) or w2.shape[0] != w.shape[0]:
            raise ValueError(
                "stream does not match UFishNet family: encoder level "
                f"{len(widths)} is not a double conv: {w.shape} then "
                f"{w2.shape}; stream: [{inventory}]"
            )
        widths.append(int(w.shape[0]))
        i += 2
        if i < len(conv_ws) and conv_ws[i].shape[2:] == (2, 2):
            break
    if i >= len(conv_ws) or conv_ws[i].shape[2:] != (2, 2):
        raise ValueError(
            "stream does not match UFishNet family: no 2x2 decoder weight "
            f"after the encoder: [{inventory}]"
        )
    up = conv_ws[i]
    # ConvTranspose2d serializes (Cin, Cout); Conv2d serializes (Cout, Cin)
    up_mode = "convtranspose" if up.shape[0] > up.shape[1] else "resize"
    if any(w % base for w in widths):
        raise ValueError(
            "stream does not match UFishNet family: encoder widths "
            f"{widths} are not multiples of base {base}: [{inventory}]"
        )
    return {
        "base_features": base,
        "depths": tuple(w // base for w in widths),
        "up_mode": up_mode,
    }


def _set_path(tree: dict, path: str, leaf: dict) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = leaf


def structural_onnx_to_flax(
    tensors: "dict[str, np.ndarray] | list[np.ndarray]",
    base_features: Optional[int] = None,
    depths: Optional[Sequence[int]] = None,
    up_mode: Optional[str] = None,
) -> dict:
    """Map ONNX initializers (in file order) onto UFishNet variables.

    With ``base_features``/``depths``/``up_mode`` omitted, the topology is
    inferred from the stream (:func:`infer_topology`). Returns the Flax
    variables dict ``{"params": ..., "batch_stats": ...}``. Raises
    ``ValueError`` with a full inventory when the tensor stream does not
    structurally match the architecture.
    """
    if isinstance(tensors, dict):
        ordered = [np.asarray(v) for v in tensors.values()]
    else:
        ordered = [np.asarray(v) for v in tensors]
    # drop empty/scalar bookkeeping tensors some exporters emit
    ordered = [t for t in ordered if t.ndim >= 1 and t.size > 0]

    inferred = infer_topology(ordered)
    if base_features is None:
        base_features = inferred["base_features"]
    if depths is None:
        depths = inferred["depths"]
    if up_mode is None:
        up_mode = inferred["up_mode"]

    seq = module_sequence(base_features, depths, up_mode)
    params: dict = {}
    batch_stats: dict = {}
    pos = 0

    def fail(msg: str) -> ValueError:
        inventory = ", ".join(str(t.shape) for t in ordered)
        return ValueError(
            f"ONNX stream does not match UFishNet(base={base_features}, "
            f"depths={tuple(depths)}, up_mode={up_mode!r}): {msg}. "
            f"Initializer shapes: [{inventory}]"
        )

    i = 0
    while i < len(seq):
        path, kind, feats = seq[i]
        if kind in ("conv", "convT"):
            if pos >= len(ordered) or ordered[pos].ndim != 4:
                raise fail(f"expected 4D conv weight for {path} at stream "
                           f"position {pos}")
            w = ordered[pos]
            pos += 1
            out_dim = w.shape[1] if kind == "convT" else w.shape[0]
            if out_dim != feats:
                raise fail(f"{path}: expected {feats} output features, ONNX "
                           f"weight has {out_dim}")
            # count the run of 1D size-feats tensors that follows
            run = 0
            while (pos + run < len(ordered) and ordered[pos + run].ndim == 1
                   and ordered[pos + run].shape[0] == feats):
                run += 1
            next_is_bn = i + 1 < len(seq) and seq[i + 1][1] == "bn"
            if next_is_bn:
                if run == 4:
                    bias = np.zeros(feats, np.float32)  # conv bias=False
                elif run >= 5:
                    bias = ordered[pos]
                    pos += 1
                else:
                    raise fail(f"{path}: expected BatchNorm tensors after the "
                               f"conv weight, found a run of {run} 1D tensors")
            else:
                if run >= 1:
                    bias = ordered[pos]
                    pos += 1
                else:
                    bias = np.zeros(feats, np.float32)
            kernel = (
                conv_transpose_to_flax(w) if kind == "convT" else conv_to_flax(w)
            )
            _set_path(params, path, {
                "kernel": kernel.astype(np.float32),
                "bias": np.asarray(bias, np.float32),
            })
        else:  # bn
            if pos + 4 > len(ordered) or any(
                ordered[pos + k].ndim != 1 or ordered[pos + k].shape[0] != feats
                for k in range(4)
            ):
                raise fail(f"expected 4 1D({feats}) BatchNorm tensors for "
                           f"{path} at stream position {pos}")
            gamma, beta, mean, var = ordered[pos : pos + 4]
            pos += 4
            _set_path(params, path, {
                "scale": np.asarray(gamma, np.float32),
                "bias": np.asarray(beta, np.float32),
            })
            _set_path(batch_stats, path, {
                "mean": np.asarray(mean, np.float32),
                "var": np.asarray(var, np.float32),
            })
        i += 1

    if pos != len(ordered):
        raise fail(f"{len(ordered) - pos} trailing initializers left over")
    return {"params": params, "batch_stats": batch_stats}


def topology_spec(
    base_features: int = 32,
    depths: Sequence[int] = (1, 2, 4),
    up_mode: str = "convtranspose",
) -> dict:
    """Serializable topology spec: forward op sequence with expected ONNX
    initializer shapes. Committed per-alias in ``ufish_topology.json`` so a
    real-checkpoint mismatch reports a precise diff."""
    ops = []
    cin = 1
    for path, kind, feats in module_sequence(base_features, depths, up_mode):
        if kind == "conv":
            k = 3 if "ConvBlock" in path else (1 if feats == 1 else 2)
            ops.append({"path": path, "op": "Conv",
                        "weight_shape": [feats, cin, k, k]})
            cin = feats
        elif kind == "convT":
            ops.append({"path": path, "op": "ConvTranspose",
                        "weight_shape": [cin, feats, 2, 2]})
            cin = feats
        else:
            ops.append({"path": path, "op": "BatchNorm",
                        "param_shapes": [[feats]] * 4})
        # after an up-level's ConvTranspose / Conv(2x2), the following
        # ConvBlock sees the skip concatenation (doubled input width)
        if kind == "convT" or (kind == "conv" and "ConvBlock" not in path
                               and feats != 1):
            cin = feats * 2
    return {
        "base_features": base_features,
        "depths": list(depths),
        "up_mode": up_mode,
        "ops": ops,
    }


def load_topology_specs() -> dict:
    with TOPOLOGY_SPEC_PATH.open("r", encoding="utf-8") as fh:
        return json.load(fh)


def load_ufish_onnx_params(
    path: Union[str, Path],
    base_features: Optional[int] = None,
    depths: Optional[Sequence[int]] = None,
    up_mode: Optional[str] = None,
) -> dict:
    """Load a U-FISH ONNX checkpoint into UFishNet variables (topology
    inferred from the file unless pinned by the caller)."""
    return structural_onnx_to_flax(
        load_onnx_initializers(path),
        base_features=base_features,
        depths=depths,
        up_mode=up_mode,
    )


def seeded_onnx_initializers(
    seed: int,
    base_features: int = 32,
    depths: Sequence[int] = (1, 2, 4),
    up_mode: str = "convtranspose",
) -> dict:
    """A checkpoint of the given family from a numpy seed, as the ordered
    ONNX initializer dict a torch export writes (feed it to
    :func:`.onnx_reader.encode_test_model`): He-normal conv weights
    (std sqrt(2 / fan-in)), zero biases, BatchNorm near identity (scale and
    variance 1 ± 0.05, shift and mean ± 0.05)."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}
    for idx, op in enumerate(topology_spec(base_features, depths, up_mode)["ops"]):
        if op["op"] == "BatchNorm":
            (feats,) = op["param_shapes"][0]
            near = lambda: (0.05 * rng.standard_normal(feats)).astype(np.float32)  # noqa: E731
            out[f"g{idx}"], out[f"be{idx}"] = 1.0 + near(), near()
            out[f"m{idx}"], out[f"v{idx}"] = near(), 1.0 + np.abs(near())
            continue
        shape = op["weight_shape"]
        # Conv (O, I, kH, kW): fan-in I*kH*kW; ConvTranspose (I, O, 2, 2)
        # at stride 2: each output takes one tap of each input channel
        fan_in = shape[1] * shape[2] * shape[3] if op["op"] == "Conv" else shape[0]
        feats = shape[0] if op["op"] == "Conv" else shape[1]
        out[f"w{idx}"] = (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        out[f"b{idx}"] = np.zeros(feats, np.float32)
    return out
