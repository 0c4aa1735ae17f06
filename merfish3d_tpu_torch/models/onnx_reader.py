"""Minimal ONNX initializer extraction (no `onnx` package required; a
copy of ``merfish3d_tpu/models/onnx_reader.py``, pure numpy).

The published U-FISH weights ship as ONNX files; the port needs neither
`onnx` nor `onnxruntime`, so this module implements just enough of the
protobuf wire format to pull the initializer tensors out of a ModelProto:

ModelProto.graph        = field 7  (GraphProto, length-delimited)
GraphProto.initializer  = field 5  (repeated TensorProto)
TensorProto.dims        = field 1  (repeated int64, varint)
TensorProto.data_type   = field 2  (varint; 1 = FLOAT)
TensorProto.float_data  = field 4  (repeated float, packed)
TensorProto.name        = field 8  (string)
TensorProto.raw_data    = field 9  (bytes)

Field numbers are fixed by the public onnx.proto schema. Conv weights come
out in ONNX (O, I, kH, kW) order; :func:`conv_to_flax` transposes to the
Flax (kH, kW, I, O) convention.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, Union

import numpy as np

_ONNX_FLOAT = 1
_ONNX_INT64 = 7


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
            yield field, wire, value
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:  # groups (3/4) unsupported — not emitted by onnx exporters
            raise ValueError(f"unsupported protobuf wire type {wire}")


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = _ONNX_FLOAT
    name = ""
    raw = b""
    floats: list[float] = []
    int64s: list[int] = []
    for field, wire, payload in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(int(payload))
        elif field == 2 and wire == 0:
            dtype = int(payload)
        elif field == 4 and wire == 2:  # packed float_data
            floats.extend(struct.unpack(f"<{len(payload) // 4}f", payload))
        elif field == 4 and wire == 5:
            floats.append(struct.unpack("<f", payload)[0])
        elif field == 7 and wire == 2:  # packed int64_data
            pos = 0
            while pos < len(payload):
                v, pos = _read_varint(payload, pos)
                int64s.append(v)
        elif field == 8 and wire == 2:
            name = payload.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = payload
    if raw:
        np_dtype = np.float32 if dtype == _ONNX_FLOAT else np.int64
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np.float32)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def load_onnx_initializers(path: Union[str, Path]) -> dict[str, np.ndarray]:
    """Extract all initializer tensors (name → array) from an ONNX file."""
    buf = Path(path).read_bytes()
    tensors: dict[str, np.ndarray] = {}
    for field, wire, payload in _iter_fields(buf):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gpayload in _iter_fields(payload):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gpayload)
                    tensors[name] = arr
    return tensors


def conv_to_flax(weight: np.ndarray) -> np.ndarray:
    """ONNX Conv weight (O, I, kH, kW) → Flax kernel (kH, kW, I, O)."""
    return np.transpose(weight, (2, 3, 1, 0))


def encode_test_model(tensors: dict[str, np.ndarray]) -> bytes:
    """Encode a minimal ModelProto holding the given initializers (used by
    the round-trip test; mirrors the subset the reader understands)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def field(num: int, wire: int, payload: bytes) -> bytes:
        return varint((num << 3) | wire) + (
            varint(len(payload)) + payload if wire == 2 else payload
        )

    graph = b""
    for name, arr in tensors.items():
        tensor = b""
        for d in arr.shape:
            tensor += varint((1 << 3) | 0) + varint(d)  # dims varint
        tensor += varint((2 << 3) | 0) + varint(_ONNX_FLOAT)
        tensor += field(8, 2, name.encode())
        tensor += field(9, 2, np.asarray(arr, np.float32).tobytes())
        graph += field(5, 2, tensor)
    return field(7, 2, graph)
