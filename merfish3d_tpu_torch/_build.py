"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use each is
compiled with ``nvcc`` for Hopper (``sm_90a``), all in parallel, and the
objects are linked into one shared library under ``_build/``, loaded with
:mod:`ctypes`; the library name carries a hash of the sources, so an
edited source rebuilds. Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc`` or a card.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0 (a refused launch never runs, and
a later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("decode.cu", "fused_decode.cu", "pfft.cu", "rlgc.cu", "conv2d.cu", "conv2d_mma.cu")
HEADERS = ("fft128.cuh", "decode_core.cuh")  # included by the sources; part of the library's hash
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# what the last build printed (ptxas register/shared-memory report) and
# how long it took; None when the library was already built
last_build_log: Optional[str] = None
last_build_seconds: Optional[float] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    conventional install prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        digest.update((SRC_DIR / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmerfish_kernels_{digest.hexdigest()[:12]}.so"


def _compile(target: Path) -> None:
    global last_build_log, last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # PID-unique temp files + atomic rename: concurrent processes never
    # load a half-written library
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = target.with_suffix(f".{tag}.so")
    t0 = time.perf_counter()
    log = []
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        failed = []
        for s, p in zip(SOURCES, procs):
            out = p.communicate()[0]
            log.append(out)
            if p.returncode != 0:
                failed.append(f"{s} ({p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        proc = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "".join(log)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.decode_chunk_f32.argtypes = [p, p, p, p, i, i, ll, ll, p, p, p, p, p]
    lib.decode_chunk_f32.restype = i
    lib.zy_lowpass_f32.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, p, p]
    lib.zy_lowpass_f32.restype = i
    lib.zy_lowpass_route.argtypes = [i, i, i, i, i, p]
    lib.zy_lowpass_route.restype = i
    lib.x_lowpass_decode_f32.argtypes = [
        p, p, p, i, p, p, p, i, i, i, i, i, f, f, f, p, p, p, p, p,
    ]
    lib.x_lowpass_decode_f32.restype = i
    lib.dft_trailing_f32.argtypes = [p] * 7 + [ll, i, i, i, p]
    lib.dft_trailing_f32.restype = i
    lib.dft_middle_f32.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.dft_middle_f32.restype = i
    lib.dft_leading_f32.argtypes = [p] * 5 + [i, i, i, ll, i, p]
    lib.dft_leading_f32.restype = i
    lib.dft_zx_f32.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.dft_zx_f32.restype = i
    lib.dft_mid_conv_f32.argtypes = [p] * 12 + [i, i, i, p]
    lib.dft_mid_conv_f32.restype = i
    lib.ratio_kld_f32.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.ratio_kld_f32.restype = i
    lib.update_select_f32.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.update_select_f32.restype = i
    lib.conv2d_same_mma_bf16.argtypes = [p] * 4 + [i] * 10 + [p]
    lib.conv2d_same_mma_bf16.restype = i
    lib.conv2d_same_f32.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.conv2d_same_f32.restype = i


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source version
    has not been built yet. Raises when ``nvcc`` is missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            target = _library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            _bind(lib)
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {status}")


def stream_handle(device) -> int:
    """Raw handle of torch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
