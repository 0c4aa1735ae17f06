"""Native host ops (counterpart of ``merfish3d_tpu/native/__init__.py``):
sparse connected-component labelling and greedy one-to-one matching.

The C++ source is this package's own ``csrc/hostops.cpp``, compiled with
``g++`` into ``_build/`` at first use. Plain C ABI over numpy buffers,
loaded with :mod:`ctypes`. Raises when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "hostops.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
            target = BUILD_DIR / f"libhostops_{digest}.so"
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            lib.greedy_match.argtypes = [i64p, i64p, f64p, i64, i64, i64, i64p]
            lib.greedy_match.restype = i64
            lib.label_components_sparse.argtypes = [
                i32p, i64, i64, i64, ctypes.c_int32, i64p, i64p, i64,
            ]
            lib.label_components_sparse.restype = i64
            _lib = lib
        return _lib


def build() -> None:
    """Compile (if needed) and load the library."""
    _load()


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def label_components_sparse(
    decoded: np.ndarray, use_2d: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """26-connected (8-connected per plane with ``use_2d``) components of
    equal decoded value over the foreground (``decoded >= 0``). Returns
    ``(lin, roots)``: the linear index of each foreground voxel in scan
    order and its component id (ids are only meaningful within one call)."""
    dec = np.ascontiguousarray(np.asarray(decoded, np.int32))
    if dec.ndim != 3:
        raise ValueError(f"decoded must be (Z, Y, X), got {dec.shape}")
    if dec.size > np.iinfo(np.int32).max:
        raise ValueError("volume too large for the native labeller")
    n_fg = int(np.count_nonzero(dec >= 0))
    if n_fg == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lin = np.empty(n_fg, np.int64)
    roots = np.empty(n_fg, np.int64)
    nz, ny, nx = dec.shape
    count = _load().label_components_sparse(
        _ptr(dec, ctypes.c_int32), nz, ny, nx, int(use_2d),
        _ptr(lin, ctypes.c_int64), _ptr(roots, ctypes.c_int64), n_fg,
    )
    if count != n_fg:
        raise RuntimeError(
            f"label_components_sparse: expected {n_fg} foreground voxels, "
            f"native returned {count}"
        )
    return lin, roots


def greedy_match(
    pair_src: np.ndarray,
    pair_dst: np.ndarray,
    pair_dist: np.ndarray,
    n_src: int,
    n_dst: int,
) -> np.ndarray:
    """Indices of the pairs accepted by distance-sorted greedy one-to-one
    matching."""
    src = np.ascontiguousarray(np.asarray(pair_src, np.int64))
    dst = np.ascontiguousarray(np.asarray(pair_dst, np.int64))
    dist = np.ascontiguousarray(np.asarray(pair_dist, np.float64))
    if not (len(src) == len(dst) == len(dist)):
        raise ValueError("pair arrays differ in length")
    if src.size and not (
        0 <= src.min() and src.max() < n_src and 0 <= dst.min() and dst.max() < n_dst
    ):
        raise ValueError("pair index out of range")
    accepted = np.empty(len(src), np.int64)
    count = _load().greedy_match(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        _ptr(dist, ctypes.c_double), len(src), n_src, n_dst,
        _ptr(accepted, ctypes.c_int64),
    )
    return accepted[:count]
